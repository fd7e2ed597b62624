// K-mer histogram kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel meshclust_tpu/ops/histogram.py:_hist_mxu_kernel
// (driven by histogram_pallas). The TPU has no fast scatter, so that kernel
// counted k-mers as a one-hot outer-product matmul on the MXU. A GPU has fast
// shared-memory atomics, so here each k-mer start is one atomicAdd into a bin.
//
// Per sequence b (one CTA each):
//   counts[b, v] = init + #{p : valid(b, p) and id(b, p) == v}
//   ones[b, c]   = #{p : in_segment(b, p) and code(b, p) == c}
//   mag[b] = sum_v counts[b, v],  sq[b] = sum_v counts[b, v]^2   (exact int64)
// where id(b, p) = sum_i code(b, p + i) * 4^(k-1-i) is the rolling base-4
// k-mer id. Codes arrive 2-bit packed (four bases a byte) and are unpacked
// here. A sequence that is one full-length segment passes no masks: then
// valid(p) = p < length - k + 1 and in_segment(p) = p < length. Sequences
// with N runs or under 20 bp pass explicit uint8 masks [B, Lp].
//
// Bins: 4^k int32 in shared memory up to k = 7 (64 KB, above the 48 KB
// static limit, so the launcher raises the dynamic shared-memory attribute).
// For k > 7 the CTA counts straight into its own output row in global memory
// with global atomics; one CTA per row keeps that race-free under
// __syncthreads().
//
// Bound: shared-memory atomics and reading the packed codes (k byte reads
// per start, served from L1). At k <= 7 a 1 kb read costs about 1,000
// atomics and 4^k bin reads for the row's epilogue; there is no reuse to win
// from tensor cores, so the design keeps everything in one pass per row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedK = 7;

__device__ __forceinline__ int code_at(const uint8_t* row, int p) {
  return (row[p >> 2] >> ((p & 3) * 2)) & 3;
}

template <bool kGlobalBins>
__global__ void __launch_bounds__(kThreads) kmer_hist_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ inseg,
    int Lp, int k, int init, int32_t* counts, int32_t* __restrict__ ones,
    int64_t* __restrict__ mag, int64_t* __restrict__ sq) {
  extern __shared__ int32_t smem_bins[];
  __shared__ int32_t s_ones[4];
  __shared__ long long s_mag[kThreads / 32];
  __shared__ long long s_sq[kThreads / 32];

  const long long b = blockIdx.x;
  const int V = 1 << (2 * k);
  int32_t* out = counts + b * V;
  int32_t* bins = kGlobalBins ? out : smem_bins;
  const uint8_t* row = packed + b * (Lp / 4);
  const uint8_t* vrow = valid ? valid + b * Lp : nullptr;
  const uint8_t* irow = inseg ? inseg + b * Lp : nullptr;
  const int len = lengths[b];

  for (int v = threadIdx.x; v < V; v += kThreads) bins[v] = 0;
  if (threadIdx.x < 4) s_ones[threadIdx.x] = 0;
  __syncthreads();

  for (int p = threadIdx.x; p < Lp; p += kThreads) {
    const bool in_seg = irow ? irow[p] != 0 : p < len;
    if (in_seg) atomicAdd(&s_ones[code_at(row, p)], 1);
    const bool starts = vrow ? vrow[p] != 0 : p + k <= len;
    if (starts) {
      int id = 0;
      for (int i = 0; i < k; ++i) id = id * 4 + code_at(row, p + i);
      atomicAdd(&bins[id], 1);
    }
  }
  __syncthreads();

  long long m = 0, s = 0;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const int32_t c = bins[v] + init;
    out[v] = c;
    m += c;
    s += static_cast<long long>(c) * c;
  }
  for (int off = 16; off > 0; off >>= 1) {
    m += __shfl_down_sync(0xffffffffu, m, off);
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_mag[warp] = m;
    s_sq[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long tm = 0, ts = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      tm += s_mag[w];
      ts += s_sq[w];
    }
    mag[b] = tm;
    sq[b] = ts;
    for (int c = 0; c < 4; ++c) ones[b * 4 + c] = s_ones[c];
  }
}

}  // namespace

// packed [B, Lp/4] uint8; lengths [B] int32; valid, inseg [B, Lp] uint8 or
// both null; counts [B, 4^k] int32; ones [B, 4] int32; mag, sq [B] int64.
// Returns cudaGetLastError() after the launch.
extern "C" int mc_kmer_hist(const void* packed, const void* lengths,
                            const void* valid, const void* inseg, int B,
                            int Lp, int k, int init, void* counts, void* ones,
                            void* mag, void* sq, void* stream) {
  if (B <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pk = static_cast<const uint8_t*>(packed);
  auto* ln = static_cast<const int32_t*>(lengths);
  auto* vd = static_cast<const uint8_t*>(valid);
  auto* is = static_cast<const uint8_t*>(inseg);
  auto* ct = static_cast<int32_t*>(counts);
  auto* on = static_cast<int32_t*>(ones);
  auto* mg = static_cast<int64_t*>(mag);
  auto* sqp = static_cast<int64_t*>(sq);
  if (k <= kMaxSharedK) {
    const int smem = static_cast<int>(sizeof(int32_t)) << (2 * k);
    cudaError_t e = cudaFuncSetAttribute(
        kmer_hist_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    kmer_hist_kernel<false><<<B, kThreads, smem, st>>>(
        pk, ln, vd, is, Lp, k, init, ct, on, mg, sqp);
  } else {
    kmer_hist_kernel<true><<<B, kThreads, 0, st>>>(
        pk, ln, vd, is, Lp, k, init, ct, on, mg, sqp);
  }
  return cudaGetLastError();
}
