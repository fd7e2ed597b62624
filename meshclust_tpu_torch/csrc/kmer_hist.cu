// K-mer histogram kernel for Hopper (sm_90a): the whole corpus in one launch.
//
// Replaces the TPU kernel meshclust_tpu/ops/histogram.py:_hist_mxu_kernel
// (driven by histogram_pallas) and the XLA work fused around it in
// featurize_batch_device (one_mer_counts, the int64 magnitude,
// seq_stats_device). The TPU has no fast scatter, so that kernel counted
// k-mers as a one-hot outer-product matmul on the MXU; a GPU has fast
// shared-memory atomics, so here each k-mer start is one shared-memory
// reduction (red.shared.add) into a bin.
//
// Input: the parser's flat codes (native/__init__.py:parse_fasta_native):
// codes [T] uint8, 0..3 inside segments (78 outside), record r at
// [rec_off[r], rec_off[r + 1]), its segments segs[seg_off[r] .. seg_off[r+1])
// as inclusive [a, b] pairs relative to the record. The buffer's address
// and length are multiples of 16 (the caller pads its tail); records are NOT
// 16-byte aligned: every lane takes one aligned 16-byte block of the buffer
// per step, and a block that holds a segment's head or tail takes the
// guarded path, which checks each base against the segment.
//
// For every record r:
//   counts[r, v] = init + #{e : window (e-k, e] lies in one segment, id = v}
//   ones[r, c]   = #{p in a segment : code(p) == c}
//   mag[r], sq[r] = sum_v counts[r, v], sum_v counts[r, v]^2   (exact int64)
//   *largest     = max over all counts (atomicMax; the caller zeroes it)
//
// Rolling ids in registers: a lane packs its 16 codes into one 32-bit word
// (2 bits a code, the first highest), takes the previous block's word from
// lane - 1 by shuffle (lane 0: lane 31 of the previous step, or a load
// before the span's first block), and reads the id of the window ending at
// each of its positions out of the 64 bits prev:cur with one funnel shift
// and the mask 4^k - 1: the rolling id ((id << 2) | c) & (4^k - 1) with no
// chain from one base to the next. It counts each window whose end e
// satisfies e >= a + k - 1 and e <= b: every window start is counted once,
// and windows across a segment boundary or a chunk boundary never. The
// 1-mer counts come from popcounts of the packed word.
//
// Work units, sized by length (the wrapper picks, ops/histogram.py):
// - rows mode: a warp a record, kWarps records a CTA (three at k = 7, where
//   a warp's bins take 64 KB), each warp with its own 4^k bins in shared
//   memory (8 KB a CTA at k = 4), persistent over records, the next
//   record's offsets loading while this one counts; the warp's epilogue
//   writes the row in place with 16-byte stores, reading and zeroing the
//   bins in one pass, and reduces sq, the 1-mer counts and the maximum from
//   the same pass (mag is 4^k init plus the record's window count).
// - split mode (long records, k <= 7): a thread block cluster of
//   kClusterCtas CTAs a record; each warp counts a contiguous share of every
//   segment into its CTA's bins (one array a warp while they fit in
//   kMergeBytes, so k <= 5 has no cross-warp contention; one shared array
//   above), then each CTA sums its slice of the row over every CTA's bins
//   through distributed shared memory (map_shared_rank) and writes it; rank 0
//   gathers the partial statistics.
// - k > 7 (4^k int32 bins: 256 KB a warp at k = 8, above a CTA's 227 KB):
//   rows mode with the bins in the output row itself (global atomics; the
//   caller zeroes the rows). It is on neither main path.
//
// Bound: bytes. One byte a base in, 4^k int32 a row out (k-mer path: ~14.9
// MB in and ~15.4 MB out at 15k reads, k = 4, ~9 us at 3.35 TB/s; 150k
// reads ~92 us); a few integer operations and one shared atomic a base. The
// design reads every base once with 16-byte loads, keeps ids in registers,
// and writes each row once, in place, with no scratch tensor or second
// pass. What is left between it and the bound is the count's issue: about
// four instructions a base (funnel shift, mask, address, red) at the 32
// warps an SM that its 64 registers allow (PERF.md, section 6).
#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 16;          // bases a lane takes a step (one uint4)
constexpr int kWarps = 8;           // warps of a CTA (rows and split mode)
constexpr int kClusterCtas = 2;     // CTAs of a cluster in split mode
constexpr int kMaxSharedK = 7;      // bins in shared memory up to this k
constexpr int kMergeBytes = 32768;  // split mode: bins a warp up to this a CTA
constexpr int kSmemBytes = 232448;  // shared memory a CTA can use (227 KB)

struct Args {
  const uint4* blocks;       // the codes as 16-byte blocks
  const int64_t* rec_off;    // [n + 1]
  const int64_t* segs;       // [S, 2], record-relative inclusive
  const int64_t* seg_off;    // [n + 1]
  int n, k, init, warps, arrays;
  int32_t* counts;           // [n, 4^k]
  int32_t* ones;             // [n, 4]
  int64_t* mag;              // [n]
  int64_t* sq;               // [n]
  int32_t* largest;          // [1]
};

struct Tally {
  int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
};

// The 16 codes of a block packed 2 bits each, the first in the highest
// bits: per word, the codes' low 2 bits in reversed byte order, gathered
// into the top byte by one multiply (the four fields land on distinct bits,
// so nothing carries).
__device__ __forceinline__ uint32_t pack_codes(uint4 b) {
  const uint32_t m = (1u << 6) | (1u << 12) | (1u << 18) | (1u << 24);
  const uint32_t x = (__byte_perm(b.x, 0, 0x0123) & 0x03030303u) * m;
  const uint32_t y = (__byte_perm(b.y, 0, 0x0123) & 0x03030303u) * m;
  const uint32_t z = (__byte_perm(b.z, 0, 0x0123) & 0x03030303u) * m;
  const uint32_t w = (__byte_perm(b.w, 0, 0x0123) & 0x03030303u) * m;
  return (x & 0xff000000u) | ((y >> 8) & 0x00ff0000u) |
         ((z >> 16) & 0x0000ff00u) | (w >> 24);
}

// Adds one to the bin id: a shared-memory reduction at the bins' shared
// address plus 4 id (one LEA and one RED a window), or a global atomic.
template <bool kGlobal>
__device__ __forceinline__ void count_id(int32_t* bins, uint32_t bins_s,
                                         uint32_t id) {
  if (kGlobal)
    atomicAdd(bins + id, 1);
  else
    asm volatile("red.shared.add.u32 [%0], 1;" ::"r"(bins_s + (id << 2))
                 : "memory");
}

// One lane counts its block (packed codes cur, positions p0 .. p0 + 15
// from the segment's first block) of the segment [a, b] (same origin);
// prev is the block before it. The id of the window ending at t is bits
// 30 - 2t .. 29 - 2t + 2k of prev:cur, one funnel shift and a mask: no id
// depends on another.
template <bool kGlobal>
__device__ __forceinline__ void count_block(uint32_t prev, uint32_t cur,
                                            int p0, int a, int b, int lo,
                                            uint32_t mask, int32_t* bins,
                                            uint32_t bins_s, Tally& tl) {
  uint32_t inseg = 0xffffffffu;   // 2 bits a code inside the segment
  if (p0 >= lo && p0 + kBlock - 1 <= b) {
#pragma unroll
    for (int t = 0; t < kBlock; ++t)
      count_id<kGlobal>(bins, bins_s,
                        __funnelshift_r(cur, prev, 30 - 2 * t) & mask);
  } else {
    const int first = max(0, a - p0), last = min(kBlock - 1, b - p0);
    const int from = max(first, lo - p0);
    inseg = (0xffffffffu >> (2 * first)) &
            (0xffffffffu << (2 * (kBlock - 1 - last)));
#pragma unroll
    for (int t = 0; t < kBlock; ++t)
      if (t >= from && t <= last)
        count_id<kGlobal>(bins, bins_s,
                          __funnelshift_r(cur, prev, 30 - 2 * t) & mask);
  }
  // 1-mer counts by popcount: code 1 = low bit, 2 = high bit, 3 = both
  const uint32_t low = 0x55555555u & inseg;
  const int b0 = __popc(cur & low), b1 = __popc((cur >> 1) & low);
  const int both = __popc(cur & (cur >> 1) & low);
  tl.n0 += __popc(low) - b0 - b1 + both;
  tl.n1 += b0 - both;
  tl.n2 += b1 - both;
  tl.n3 += both;
}

// One warp counts blocks [j0, j1) of the buffer, which hold the segment
// [A, B] (buffer positions), into bins, 32 blocks a step: lane l takes
// block j0 + base + l and passes its packed codes to lane l + 1 (lane 31's
// to lane 0 of the next step). Positions inside are 32-bit, from block j0
// (a segment is shorter than 2^31 - 64 bases). All 32 lanes must call it
// together.
template <bool kGlobal>
__device__ __forceinline__ void count_span(const Args& p, long long j0,
                                           long long j1, long long A,
                                           long long B, int32_t* bins,
                                           Tally& tl) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const uint32_t mask = (1u << (2 * p.k)) - 1u;
  const uint4* blocks = p.blocks + j0;
  const int n = static_cast<int>(j1 - j0);
  const int a = static_cast<int>(A - j0 * kBlock);
  const int b = static_cast<int>(B - j0 * kBlock);
  const int lo = a + p.k - 1;      // the first window end counted
  const uint32_t bins_s =
      kGlobal ? 0u : static_cast<uint32_t>(__cvta_generic_to_shared(bins));
  uint32_t carry = j0 > 0 ? pack_codes(__ldg(blocks - 1)) : 0u;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const uint32_t cur = i < n ? pack_codes(__ldg(blocks + i)) : 0u;
    uint32_t prev = __shfl_up_sync(full, cur, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(full, cur, 31);
    if (i < n)
      count_block<kGlobal>(prev, cur, i * kBlock, a, b, lo, mask, bins,
                           bins_s, tl);
  }
}

// Adds init to c in place and folds it into the row's sums and maximum.
__device__ __forceinline__ void add_row(int4& c, int init, long long& m,
                                        long long& s, int& mx) {
  c.x += init;
  c.y += init;
  c.z += init;
  c.w += init;
  m += (long long)c.x + c.y + c.z + c.w;
  s += (long long)c.x * c.x + (long long)c.y * c.y + (long long)c.z * c.z +
       (long long)c.w * c.w;
  mx = max(mx, max(max(c.x, c.y), max(c.z, c.w)));
}

// Warp sums and maximum by REDUX (one instruction each). A 64-bit sum
// goes as three 21-bit fields, whose 32-lane sums stay below 2^26.
__device__ __forceinline__ int warp_sum(int v) {
  return static_cast<int>(__reduce_add_sync(0xffffffffu, v));
}

__device__ __forceinline__ long long warp_sum(long long v) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  const unsigned m = (1u << 21) - 1u;
  const unsigned long long s0 =
      __reduce_add_sync(0xffffffffu, static_cast<unsigned>(u) & m);
  const unsigned long long s1 =
      __reduce_add_sync(0xffffffffu, static_cast<unsigned>(u >> 21) & m);
  const unsigned long long s2 =
      __reduce_add_sync(0xffffffffu, static_cast<unsigned>(u >> 42));
  return static_cast<long long>(s0 + (s1 << 21) + (s2 << 42));
}

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(0xffffffffu, v);
}

// Rows mode: warp w of CTA b takes records b * warps + w, then strides by
// the grid's warps.
template <bool kGlobal>
__global__ void __launch_bounds__(kWarps * 32)
    kmer_rows_kernel(Args p) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int V = 1 << (2 * p.k);
  int32_t* bins = kGlobal ? nullptr : smem + (size_t)warp * V;
  if (!kGlobal) {
    for (int v = lane; v < V; v += 32) bins[v] = 0;
    __syncwarp();
  }
  int mx = 0;
  // The next record's offsets and first segment load while this one counts.
  const long long stride = (long long)gridDim.x * p.warps;
  long long r = (long long)blockIdx.x * p.warps + warp;
  long long base = 0, s0 = 0, s1 = 0, fa = 0, fb = 0;
  if (r < p.n) {
    base = p.rec_off[r];
    s0 = p.seg_off[r];
    s1 = p.seg_off[r + 1];
    if (s1 > s0) {
      fa = p.segs[2 * s0];
      fb = p.segs[2 * s0 + 1];
    }
  }
  for (; r < p.n; r += stride) {
    const long long rn = r + stride;
    long long nbase = 0, ns0 = 0, ns1 = 0;
    if (rn < p.n) {
      nbase = p.rec_off[rn];
      ns0 = p.seg_off[rn];
      ns1 = p.seg_off[rn + 1];
    }
    int32_t* row = p.counts + r * V;
    int32_t* b = kGlobal ? row : bins;
    Tally tl;
    long long m = (long long)V * p.init;   // init a bin, one a window
    for (long long s = s0; s < s1; ++s) {
      const long long a = s == s0 ? fa : p.segs[2 * s];
      const long long e = s == s0 ? fb : p.segs[2 * s + 1];
      m += max(0LL, e - a + 2 - p.k);
      count_span<kGlobal>(p, (base + a) / kBlock, (base + e) / kBlock + 1,
                          base + a, base + e, b, tl);
    }
    long long nfa = 0, nfb = 0;
    if (ns1 > ns0) {
      nfa = p.segs[2 * ns0];
      nfb = p.segs[2 * ns0 + 1];
    }
    __syncwarp();
    if (kGlobal) __threadfence_block();
    long long unused = 0, sqs = 0;
    for (int v = 4 * lane; v < V; v += 128) {
      int4 c;
      if (kGlobal) {
        c = __ldcg(reinterpret_cast<const int4*>(b + v));
      } else {
        c = *reinterpret_cast<int4*>(b + v);
        *reinterpret_cast<int4*>(b + v) = make_int4(0, 0, 0, 0);
      }
      add_row(c, p.init, unused, sqs, mx);
      *reinterpret_cast<int4*>(row + v) = c;
    }
    sqs = warp_sum(sqs);
    const int n0 = warp_sum(tl.n0), n1 = warp_sum(tl.n1),
              n2 = warp_sum(tl.n2), n3 = warp_sum(tl.n3);
    if (lane == 0) {
      p.mag[r] = m;
      p.sq[r] = sqs;
      *reinterpret_cast<int4*>(p.ones + 4 * r) = make_int4(n0, n1, n2, n3);
    }
    __syncwarp();
    base = nbase;
    s0 = ns0;
    s1 = ns1;
    fa = nfa;
    fb = nfb;
  }
  mx = warp_max(mx);
  if (lane == 0 && mx > 0) atomicMax(p.largest, mx);
}

// Split mode: cluster c takes records c, c + clusters, ...; its
// kClusterCtas x kWarps warps share every segment of the record.
__global__ void __launch_bounds__(kWarps * 32)
    kmer_split_kernel(Args p) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ long long w_sum[kWarps][2];
  __shared__ int w_int[kWarps][5];
  __shared__ long long c_sum[2];     // this CTA's share, read by rank 0
  __shared__ int c_int[5];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int V = 1 << (2 * p.k);
  const int all = p.arrays * V;
  int32_t* bins = smem + (size_t)(warp % p.arrays) * V;
  for (int v = threadIdx.x; v < all; v += blockDim.x) smem[v] = 0;
  __syncthreads();
  const long long team = (long long)C * kWarps;
  const long long tw = (long long)rank * kWarps + warp;
  int mx_all = 0;
  for (long long r = blockIdx.x / C; r < p.n; r += gridDim.x / C) {
    const long long base = p.rec_off[r];
    Tally tl;
    for (long long s = p.seg_off[r]; s < p.seg_off[r + 1]; ++s) {
      const long long A = base + p.segs[2 * s], B = base + p.segs[2 * s + 1];
      const long long j0 = A / kBlock, j1 = B / kBlock + 1;
      const long long share = (j1 - j0 + team - 1) / team;
      const long long a0 = j0 + tw * share;
      const long long a1 = min(a0 + share, j1);
      if (a0 < a1) count_span<false>(p, a0, a1, A, B, bins, tl);
    }
    cluster.sync();
    // this CTA's slice of the row: 16-byte vectors q = rank, rank + C, ...
    int32_t* row = p.counts + r * V;
    long long m = 0, sqs = 0;
    int mx = 0;
    for (int q = rank * blockDim.x + threadIdx.x; q < V / 4;
         q += C * blockDim.x) {
      int4 acc = make_int4(0, 0, 0, 0);
      for (int src = 0; src < C; ++src) {
        const int32_t* rb = cluster.map_shared_rank(&smem[0], src);
        for (int a = 0; a < p.arrays; ++a) {
          const int4 c = *reinterpret_cast<const int4*>(rb + a * V + 4 * q);
          acc.x += c.x;
          acc.y += c.y;
          acc.z += c.z;
          acc.w += c.w;
        }
      }
      add_row(acc, p.init, m, sqs, mx);
      *reinterpret_cast<int4*>(row + 4 * q) = acc;
    }
    m = warp_sum(m);
    sqs = warp_sum(sqs);
    const int n0 = warp_sum(tl.n0), n1 = warp_sum(tl.n1),
              n2 = warp_sum(tl.n2), n3 = warp_sum(tl.n3);
    mx = warp_max(mx);
    if (lane == 0) {
      w_sum[warp][0] = m;
      w_sum[warp][1] = sqs;
      w_int[warp][0] = n0;
      w_int[warp][1] = n1;
      w_int[warp][2] = n2;
      w_int[warp][3] = n3;
      w_int[warp][4] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      long long tm = 0, ts = 0;
      int ti[5] = {0, 0, 0, 0, 0};
      for (int w = 0; w < kWarps; ++w) {
        tm += w_sum[w][0];
        ts += w_sum[w][1];
        for (int i = 0; i < 4; ++i) ti[i] += w_int[w][i];
        ti[4] = max(ti[4], w_int[w][4]);
      }
      c_sum[0] = tm;
      c_sum[1] = ts;
      for (int i = 0; i < 5; ++i) c_int[i] = ti[i];
    }
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
      long long tm = 0, ts = 0;
      int ti[5] = {0, 0, 0, 0, 0};
      for (int src = 0; src < C; ++src) {
        const long long* cs = cluster.map_shared_rank(&c_sum[0], src);
        const int* ci = cluster.map_shared_rank(&c_int[0], src);
        tm += cs[0];
        ts += cs[1];
        for (int i = 0; i < 4; ++i) ti[i] += ci[i];
        ti[4] = max(ti[4], ci[4]);
      }
      p.mag[r] = tm;
      p.sq[r] = ts;
      *reinterpret_cast<int4*>(p.ones + 4 * r) =
          make_int4(ti[0], ti[1], ti[2], ti[3]);
      mx_all = max(mx_all, ti[4]);
    }
    for (int v = threadIdx.x; v < all; v += blockDim.x) smem[v] = 0;
    cluster.sync();
  }
  if (rank == 0 && threadIdx.x == 0 && mx_all > 0)
    atomicMax(p.largest, mx_all);
}

template <typename Kernel>
cudaError_t launch_rows(Kernel kernel, Args p, int smem_per_warp,
                        cudaStream_t st) {
  int warps = kWarps;
  if (smem_per_warp > 0)
    warps = std::min(kWarps, kSmemBytes / smem_per_warp);
  p.warps = warps;
  const int smem = warps * smem_per_warp;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    warps * 32, smem);
  if (e != cudaSuccess) return e;
  const long long need = (p.n + warps - 1) / warps;
  const long long grid =
      std::min(need, static_cast<long long>(std::max(per_sm, 1)) * sms);
  kernel<<<(unsigned)grid, warps * 32, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// codes [T] uint8 (T and the address multiples of 16); rec_off, seg_off
// [n + 1] int64; segs [S, 2] int64; split: 1 for split mode (k <= 7);
// counts [n, 4^k] int32 (zeroed by the caller when k > 7); ones [n, 4]
// int32; mag, sq [n] int64; largest [1] int32, zeroed by the caller.
// Returns cudaGetLastError() after the launch.
extern "C" int mc_kmer_hist(const void* codes, const void* rec_off,
                            const void* segs, const void* seg_off, int n,
                            int k, int init, int split, void* counts,
                            void* ones, void* mag, void* sq, void* largest,
                            void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p;
  p.blocks = static_cast<const uint4*>(codes);
  p.rec_off = static_cast<const int64_t*>(rec_off);
  p.segs = static_cast<const int64_t*>(segs);
  p.seg_off = static_cast<const int64_t*>(seg_off);
  p.n = n;
  p.k = k;
  p.init = init;
  p.warps = kWarps;
  p.arrays = 1;
  p.counts = static_cast<int32_t*>(counts);
  p.ones = static_cast<int32_t*>(ones);
  p.mag = static_cast<int64_t*>(mag);
  p.sq = static_cast<int64_t*>(sq);
  p.largest = static_cast<int32_t*>(largest);
  const int bin_bytes = static_cast<int>(sizeof(int32_t)) << (2 * k);
  if (k > kMaxSharedK) return launch_rows(kmer_rows_kernel<true>, p, 0, st);
  if (!split) return launch_rows(kmer_rows_kernel<false>, p, bin_bytes, st);
  p.arrays = bin_bytes * kWarps <= kMergeBytes ? kWarps : 1;
  const int smem = p.arrays * bin_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kmer_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n) * kClusterCtas);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kmer_split_kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
