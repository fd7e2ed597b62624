// Shared by the port's Phase A and Phase B kernels (phase_a.cu, phase_b.cu):
// the block size, the reductions, the rows read in pieces and their sums
// (man, dot, sum min), the floored mean served from shared memory, and the
// float64 classifier of ops/classifier.py:Model, each operation rounded as
// the plain PyTorch version's. Each source includes it in its own anonymous
// namespace, so nothing here is linked across sources.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// pa_sums and pa_move: the widest piece of a row a lane loads, and
// the loads a lane has in flight before it reduces.
constexpr int kPieceBytes = 16;
constexpr int kUnroll = 4;

// ops/features.py's flags
constexpr int kFeatLD = 1 << 1, kFeatManhattan = 1 << 2,
              kFeatIntersection = 1 << 4, kFeatPearson = 1 << 5,
              kFeatSimRatio = 1 << 6, kFeatKulczynski2 = 1 << 10;
constexpr int kComboSquared = 1;
// Most singles a model has: its singles are distinct flags
// (Feature.add_feature), and the kernels compute six
// (ops/classifier.py:Model checks both).
constexpr int kMaxSingles = 6;
// The bytes of the floored mean a block keeps in shared memory (V in
// chunks of that): tile_dist.
constexpr int kCwBytes = 8192;

__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }

struct Min {
  __device__ i64 operator()(i64 a, i64 b) const { return imin(a, b); }
};
struct Max {
  __device__ i64 operator()(i64 a, i64 b) const { return imax(a, b); }
};
struct Sum {
  __device__ i64 operator()(i64 a, i64 b) const { return a + b; }
};

__device__ __forceinline__ i64 shfl(i64 v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}

template <class T, class Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, shfl(v, o));
  return v;
}

// The reduction of v over the block, valid in thread 0.
template <class T, class Op>
__device__ T block_reduce(T v, Op op) {
  __shared__ T part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_reduce(v, op);
  __syncthreads();                  // part may hold an earlier reduction
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) v = op(v, part[w]);
  return v;
}

// Called by every thread of each of `blocks` blocks after its block's
// global writes: true in the block that finishes last, which may then read
// the others' writes. That block resets the ticket for the next launch.
__device__ bool last_block(i64* ticket, i64 blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<u64*>(ticket), 1ull) ==
           static_cast<u64>(blocks - 1);
  __syncthreads();
  if (last && threadIdx.x == 0) *ticket = 0;
  return last;
}

// The rows are read in pieces of VEC bytes, one load instruction a lane:
// 16 bytes where the rows' base, pitch and length are all multiples of 16,
// else the widest of 8, 4, 2 and 1 that divides them (a column slice
// at an odd offset, rows of 4 int8 counts at k = 1); mc_pa_sums picks VEC.
template <int VEC>
struct Piece {
  static constexpr int kWords = VEC >= 4 ? VEC / 4 : 1;
  uint32_t w[kWords];
};

// A piece of a slot's row: each is read once a launch, so 16-byte pieces
// skip L1 (L2 keeps them for the next iteration's window).
template <int VEC>
__device__ __forceinline__ Piece<VEC> load_row(const char* p) {
  Piece<VEC> r;
  if constexpr (VEC == 16) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
        : "l"(p));
  } else if constexpr (VEC == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else if constexpr (VEC == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VEC == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
  return r;
}

// A piece of the center's row through L1: every warp of an SM reads it.
template <int VEC>
__device__ __forceinline__ Piece<VEC> load_center(const char* p) {
  if constexpr (VEC == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    return {{v.x, v.y, v.z, v.w}};
  } else {
    return load_row<VEC>(p);
  }
}

// A lane's partial sums: 32 bits for int8 counts, 64 otherwise.
template <typename T>
struct Acc {
  typedef i64 type;
};
template <>
struct Acc<int8_t> {
  typedef int type;
};

// man += sum |a - b| and dot += sum a * b over one piece. int8: byte SIMD,
// |a - b| by __vsadu4 on the counts biased to unsigned (x ^ 0x80 keeps
// every difference) and a * b by __dp4a, exact in 32 bits (a piece adds at
// most 16 * 128^2 = 2^18); int16: each difference and product in 32 bits
// (32768^2 = 2^30), summed in 64; int32 and int64: 64 bits, int64 wrapping
// as torch's.
template <typename T, int VEC>
__device__ __forceinline__ void add_piece(const Piece<VEC>& a,
                                          const Piece<VEC>& b,
                                          typename Acc<T>::type& man,
                                          typename Acc<T>::type& dot) {
  if constexpr (sizeof(T) == 1 && VEC >= 4) {
#pragma unroll
    for (int i = 0; i < Piece<VEC>::kWords; ++i) {
      man += static_cast<int>(
          __vsadu4(a.w[i] ^ 0x80808080u, b.w[i] ^ 0x80808080u));
      dot = __dp4a(static_cast<int>(a.w[i]), static_cast<int>(b.w[i]), dot);
    }
  } else if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int x = static_cast<int8_t>(a.w[0] >> (8 * e));
      const int y = static_cast<int8_t>(b.w[0] >> (8 * e));
      man += x > y ? x - y : y - x;
      dot += x * y;
    }
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      const int x = static_cast<int16_t>(a.w[e / 2] >> (16 * (e & 1)));
      const int y = static_cast<int16_t>(b.w[e / 2] >> (16 * (e & 1)));
      man += x > y ? x - y : y - x;
      dot += x * y;
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < VEC / 4; ++e) {
      const i64 x = static_cast<int>(a.w[e]), y = static_cast<int>(b.w[e]);
      man += x > y ? x - y : y - x;
      dot += x * y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC / 8; ++e) {
      const u64 x = a.w[2 * e] | static_cast<u64>(a.w[2 * e + 1]) << 32;
      const u64 y = b.w[2 * e] | static_cast<u64>(b.w[2 * e + 1]) << 32;
      const i64 d = static_cast<i64>(x) > static_cast<i64>(y)
                        ? static_cast<i64>(x - y)
                        : static_cast<i64>(y - x);
      man += d;
      dot += static_cast<i64>(x * y);
    }
  }
}

// The sum over a group of `lanes` neighbouring lanes (a power of two).
template <typename A>
__device__ __forceinline__ A group_sum(A v, int lanes) {
  for (int o = lanes >> 1; o; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The classifier, packed by ops/classifier.py:Model:
//   spec (int32): S, J, singles[S], is_sim[S], kinds[J], off[J + 1], idx[..]
//   coef (f64):   V, mins[S], spans[S], weights[J + 1]
// The flags of the singles the model has (each computed once a pair).
__device__ __forceinline__ int model_flags(const int* spec) {
  const int S = spec[0];
  int flags = 0;
#pragma unroll
  for (int i = 0; i < kMaxSingles; ++i)
    if (i < S) flags |= spec[2 + i];
  return flags;
}

// What the classifier takes of one side of a pair that depends on that
// side alone: its mag, sq and length, Kulczynski's mag / V and Pearson's
// rounded mean and centred norm, each in the plain version's operations.
// A kernel that meets a row in several pairs computes them once.
struct RowTerms {
  double mag, sq, len, kap, pap, pn;
};

__device__ __forceinline__ RowTerms row_terms(int flags, double V, double mag,
                                              double sq, double len) {
  RowTerms r = {mag, sq, len, 0.0, 0.0, 0.0};
  if (flags & kFeatKulczynski2) r.kap = __ddiv_rn(mag, V);
  if (flags & kFeatPearson) {
    r.pap = floor(__dadd_rn(__ddiv_rn(mag, V), 0.5));
    r.pn = __dadd_rn(__dsub_rn(sq, __dmul_rn(__dmul_rn(2.0, r.pap), mag)),
                     __dmul_rn(__dmul_rn(V, r.pap), r.pap));
  }
  return r;
}

// Scorer.__call__ for one pair (a: the center, b: the slot), op for op,
// from the two sides' RowTerms: -> score >= 0, and f1 (the first combo's
// product). Each single flag the model has is computed once; the
// normalized singles norm[] stay in registers (kMaxSingles unrolled,
// picked by predicated selects).
__device__ bool classify_terms(const int* spec, const double* coef,
                               int flags, double man, double dot,
                               const RowTerms& a, const RowTerms& b,
                               double* f1_out) {
  const int S = spec[0], J = spec[1];
  const int* singles = spec + 2;
  const int* is_sim = singles + S;
  const int* kinds = is_sim + S;
  const int* off = kinds + J;
  const int* idx = off + J + 1;
  const double V = coef[0];
  const double* mins = coef + 1;
  const double* spans = mins + S;
  const double* weights = spans + S;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  double ld = nan, inter = nan, kulc = nan, simr = nan, pear = nan;
  if (flags & kFeatLD) ld = fabs(__dsub_rn(a.len, b.len));
  if (flags & (kFeatIntersection | kFeatKulczynski2)) {
    const double mm = __dadd_rn(a.mag, b.mag);
    const double min_sum = __ddiv_rn(__dsub_rn(mm, man), 2.0);
    if (flags & kFeatIntersection)
      inter = __ddiv_rn(__dmul_rn(2.0, min_sum), mm);
    if (flags & kFeatKulczynski2) {
      const double coeff =
          __ddiv_rn(__dmul_rn(V, __dadd_rn(a.kap, b.kap)),
                    __dmul_rn(__dmul_rn(2.0, a.kap), b.kap));
      kulc = __dmul_rn(coeff, min_sum);
    }
  }
  if (flags & kFeatSimRatio) {
    double norm2 = __dsub_rn(__dadd_rn(a.sq, b.sq), __dmul_rn(2.0, dot));
    norm2 = norm2 < 0.0 ? 0.0 : norm2;            // clamp(min=0); NaN stays
    simr = __ddiv_rn(dot, __dadd_rn(dot, __dsqrt_rn(norm2)));
  }
  if (flags & kFeatPearson) {
    const double dotc = __dadd_rn(
        __dsub_rn(__dsub_rn(dot, __dmul_rn(a.pap, b.mag)),
                  __dmul_rn(b.pap, a.mag)),
        __dmul_rn(__dmul_rn(V, a.pap), b.pap));
    double p = __dmul_rn(a.pn, b.pn);
    p = p < 0.5 ? 0.5 : p;                        // clamp(min=0.5)
    pear = __ddiv_rn(dotc, __dsqrt_rn(p));
  }
  double norm[kMaxSingles];
#pragma unroll
  for (int i = 0; i < kMaxSingles; ++i) {
    norm[i] = 0.0;
    if (i < S) {
      const int f = singles[i];
      const double v = f == kFeatLD             ? ld
                       : f == kFeatManhattan    ? man
                       : f == kFeatIntersection ? inter
                       : f == kFeatKulczynski2  ? kulc
                       : f == kFeatSimRatio     ? simr
                       : f == kFeatPearson      ? pear
                                                : nan;
      const double nv = __ddiv_rn(__dsub_rn(v, mins[i]), spans[i]);
      norm[i] = is_sim[i] ? nv : __dsub_rn(1.0, nv);
    }
  }
  double score = weights[0], f1 = 0.0;
  for (int j = 0; j < J; ++j) {
    double prod = 1.0;
    for (int e = off[j]; e < off[j + 1]; ++e) {
      const int k = idx[e];
      double c = norm[0];
#pragma unroll
      for (int i = 1; i < kMaxSingles; ++i) c = k == i ? norm[i] : c;
      prod = __dmul_rn(prod, kinds[j] == kComboSquared ? __dmul_rn(c, c) : c);
    }
    if (j == 0) f1 = prod;
    score = __dadd_rn(score, __dmul_rn(weights[j + 1], prod));
  }
  *f1_out = f1;
  return score >= 0.0;
}

// classify_terms for a pair given by its sides' mag, sq and length.
__device__ bool classify(const int* spec, const double* coef, double man,
                         double dot, double mag_a, double mag_b, double sq_a,
                         double sq_b, double len_a, double len_b,
                         double* f1_out) {
  const int flags = model_flags(spec);
  const double V = coef[0];
  return classify_terms(spec, coef, flags, man, dot,
                        row_terms(flags, V, mag_a, sq_a, len_a),
                        row_terms(flags, V, mag_b, sq_b, len_b), f1_out);
}

// A piece of the floored mean in shared memory (16-byte aligned there).
template <int VEC>
__device__ __forceinline__ Piece<VEC> load_shared(const char* p) {
  Piece<VEC> r;
  if constexpr (VEC == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r.w[0] = v.x, r.w[1] = v.y, r.w[2] = v.z, r.w[3] = v.w;
  } else if constexpr (VEC == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r.w[0] = v.x, r.w[1] = v.y;
  } else if constexpr (VEC == 4) {
    r.w[0] = *reinterpret_cast<const unsigned int*>(p);
  } else if constexpr (VEC == 2) {
    r.w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else {
    r.w[0] = *reinterpret_cast<const unsigned char*>(p);
  }
  return r;
}

// acc += sum min(a, m) over one piece of a row (a) and of the floored mean
// (m). int8: four bytes an instruction, the signed byte minimum (__vmins4)
// summed by __dp4a against ones, exact in 32 bits (a piece adds at most
// 16 * 127); wider rows element by element in 32 or 64 bits.
template <typename T, int VEC>
__device__ __forceinline__ void add_min(const Piece<VEC>& a,
                                        const Piece<VEC>& m,
                                        typename Acc<T>::type& acc) {
  if constexpr (sizeof(T) == 1 && VEC >= 4) {
#pragma unroll
    for (int i = 0; i < Piece<VEC>::kWords; ++i)
      acc = __dp4a(static_cast<int>(__vmins4(a.w[i], m.w[i])), 0x01010101,
                   acc);
  } else if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int x = static_cast<int8_t>(a.w[0] >> (8 * e));
      const int y = static_cast<int8_t>(m.w[0] >> (8 * e));
      acc += x < y ? x : y;
    }
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      const int x = static_cast<int16_t>(a.w[e / 2] >> (16 * (e & 1)));
      const int y = static_cast<int16_t>(m.w[e / 2] >> (16 * (e & 1)));
      acc += x < y ? x : y;
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < VEC / 4; ++e) {
      const int x = static_cast<int>(a.w[e]), y = static_cast<int>(m.w[e]);
      acc += x < y ? x : y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC / 8; ++e) {
      const i64 x = static_cast<i64>(a.w[2 * e] |
                                     static_cast<u64>(a.w[2 * e + 1]) << 32);
      const i64 y = static_cast<i64>(m.w[2 * e] |
                                     static_cast<u64>(m.w[2 * e + 1]) << 32);
      acc += x < y ? x : y;
    }
  }
}

// dl[i] (first chunk) or dl[i] += (later chunks) 2 * sum min(h[s], cw) over
// one chunk of V for each member s = list[i] of list[0, m), and dist[s] =
// dl[i]: nv pieces of VEC bytes a row, the chunk's cw and dl in shared
// memory. Short rows (nv <= 32, the
// k-mer path's 256 int8 counts: 16 pieces): a group of `lanes` lanes a
// member, its cw piece in a register, kUnroll members' loads in flight
// before any reduction. Long rows: a warp a member, kUnroll pieces a lane
// in flight.
template <typename T, int VEC>
__device__ void serve_members(const int* list, int m, const char* rows,
                              i64 pitch, int nv, const char* cw, bool first,
                              i64* dl, i64* __restrict__ dist) {
  typedef typename Acc<T>::type A;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  if (nv <= lanes) {
    const int sub = lane & (lanes - 1), grp = lane / lanes;
    const int groups = 32 / lanes, step = groups * kUnroll;
    const Piece<VEC> w =
        sub < nv ? load_shared<VEC>(cw + sub * VEC) : Piece<VEC>{};
    for (int i0 = warp * step; i0 < m; i0 += kWarps * step) {
      Piece<VEC> b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * groups + grp;
        b[u] = Piece<VEC>{};
        if (i < m && sub < nv)
          b[u] = load_row<VEC>(rows + list[i] * pitch + sub * VEC);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        A acc = 0;
        add_min<T, VEC>(b[u], w, acc);
        acc = group_sum(acc, lanes);
        const int i = i0 + u * groups + grp;
        if (i < m && sub == 0) {
          const i64 d = 2 * static_cast<i64>(acc) + (first ? 0 : dl[i]);
          dl[i] = d;
          if (dist) dist[list[i]] = d;
        }
      }
    }
    return;
  }
  for (int i = warp; i < m; i += kWarps) {
    const i64 s = list[i];
    const char* r = rows + s * pitch;
    i64 acc = 0;
    for (int p0 = lane; p0 < nv; p0 += 32 * kUnroll) {
      Piece<VEC> b[kUnroll], w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + 32 * u;
        b[u] = w[u] = Piece<VEC>{};
        if (p < nv) {
          b[u] = load_row<VEC>(r + static_cast<i64>(p) * VEC);
          w[u] = load_shared<VEC>(cw + p * VEC);
        }
      }
      A part = 0;                      // kUnroll pieces: within 32 bits
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_min<T, VEC>(b[u], w[u], part);
      acc += part;
    }
    acc = group_sum(acc, 32);
    if (lane == 0) {
      const i64 d = 2 * acc + (first ? 0 : dl[i]);
      dl[i] = d;
      if (dist) dist[s] = d;
    }
  }
}

// Chunk by chunk of V (kCwBytes of the rows' dtype, one chunk at V = 256):
// cw = floor(sumvec / count) into shared memory once, divided in float64 as
// mean_floor does, and each member of list[0, m) served from it
// (serve_members, each member's distance in dl). sv0 is sumvec[tid],
// loaded beside the owners. -> this thread's part of sum cw.
template <typename T, int VEC>
__device__ i64 tile_dist(const char* __restrict__ rows, i64 pitch, int V,
                         const i64* __restrict__ sumvec, i64 sv0,
                         double count, const int* list, int m, char* cw_s,
                         i64* dl, i64* __restrict__ dist) {
  const int tid = threadIdx.x;
  constexpr int kChunk = kCwBytes / static_cast<int>(sizeof(T));
  T* cw = reinterpret_cast<T*>(cw_s);
  i64 cw_sum = 0;
  for (int c0 = 0; c0 < V; c0 += kChunk) {
    const int len = V - c0 < kChunk ? V - c0 : kChunk;
    if (c0) __syncthreads();          // every member served from the last
    for (int v = tid; v < len; v += kThreads) {
      const i64 sv = c0 == 0 && v == tid ? sv0 : sumvec[c0 + v];
      const i64 x = static_cast<i64>(
          floor(__ddiv_rn(static_cast<double>(sv), count)));
      cw[v] = static_cast<T>(x);
      cw_sum += x;
    }
    __syncthreads();
    if (m)
      serve_members<T, VEC>(list, m, rows + static_cast<i64>(c0) * sizeof(T),
                            pitch, len * static_cast<int>(sizeof(T)) / VEC,
                            cw_s, c0 == 0, dl, dist);
  }
  return cw_sum;
}

}  // namespace

// -- host side --------------------------------------------------------------

// Blocks of kThreads that the card keeps resident at once running `kernel`
// (SMs x blocks an SM): the grid of pa_sums and pa_absorb, which walk any
// range in grid strides. Each launcher queries it once a process.
template <class K>
static int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// The widest piece, at most kPieceBytes and at least the element, that
// divides the rows' address, pitch and length in bytes.
static int piece_bytes(const void* rows, i64 pitch, i64 length, int width) {
  const u64 all = reinterpret_cast<u64>(rows) | static_cast<u64>(pitch) |
                  static_cast<u64>(length);
  int vec = kPieceBytes;
  while (vec > width && (all & (vec - 1))) vec >>= 1;
  return vec;
}

// The rows' element type and piece, one case X(T, VEC) each: `width` bytes
// an element, pieces of `vec` bytes (piece_bytes).
#define MC_ROW_CASES(X)                                               \
  switch (width) {                                                    \
    case 1:                                                           \
      switch (vec) { X(int8_t, 16); X(int8_t, 8); X(int8_t, 4);       \
                     X(int8_t, 2); X(int8_t, 1); }                    \
      break;                                                          \
    case 2:                                                           \
      switch (vec) { X(int16_t, 16); X(int16_t, 8); X(int16_t, 4);    \
                     X(int16_t, 2); }                                 \
      break;                                                          \
    case 4:                                                           \
      switch (vec) { X(int32_t, 16); X(int32_t, 8); X(int32_t, 4); }  \
      break;                                                          \
    case 8:                                                           \
      switch (vec) { X(int64_t, 16); X(int64_t, 8); }                 \
      break;                                                          \
  }                                                                   \
  return cudaErrorInvalidValue
