// Phase A's absorb iteration for Hopper (sm_90a): five kernels over the live
// window, with the slot state on the device.
//
// Replaces, as XLA and not Pallas, the absorb iteration of
// meshclust_tpu/core/accumulate_device.py:87 build_accumulate: its
// window_bounds (:173), classify_full (:237) and mean_argmin_full (:394),
// which the JAX package runs inside one lax.while_loop. The port's host loop
// (core/accumulate_device.py) launches, an absorb iteration:
//   pa_window       the live window [w0, w1] of the center (bvec::get_range,
//                   every case of bvec::inner_index_of) and the first live
//                   slot, as masked atomic min and max over the slots;
//   pa_sums         man = sum |a - b| and dot = sum a * b of the center's row
//                   against each live row of the window (Scorer.sums), int64;
//   pa_absorb       the float64 classifier on each live slot of the window
//                   (Scorer.__call__), the absorb of the positives (owner,
//                   stamp, active, n_pos, their rows added into sumvec) and
//                   the first max of f1 (the next seed);
// then the host reads back four scalars, and if the iteration absorbed, it
// moves the center:
//   pa_member_dist  cw = floor(sumvec / count), and 2 * sum min(h, cw) of
//                   each member's row (owner == c), and sum cw;
//   pa_mean_argmin  the member closest to the mean by distance_d, ties to
//                   the least stamp, then the least slot: the new center.
// Under a mesh (parallel/dist) each rank's pa_sums and pa_member_dist write
// partials over its slice of the feature axis, which one all-reduce sums
// before the next kernel.
//
// State: st, one int64 buffer (ops/phase_a.py names its slots): n_pos, best,
// center slot, first live slot (the readback), w0, w1, the member count, the
// window's reduction scratch and one ticket a kernel. Every reduction is
// exact and independent of the order in which blocks run: integer atomicMin,
// atomicMax and atomicAdd, or per-block partials that the last block to
// finish (the one that draws the last ticket) combines under explicit tie
// rules. So every result is bit-equal to the plain version's. No float is
// ever summed. Every float64 operation of the classifier and of the mean is
// an explicit round-to-nearest intrinsic in the plain version's order: nvcc
// contracts a * b + c into an FMA by default (--fmad=true), and the decisions
// would drift from the host classifier's.
//
// Bound: bytes, each kernel's (chip_smoke.py:phase_a_traffic counts them
// from a run's data):
//   pa_window       active of every slot (1 B), bin and len of the live
//                   ones (16 B);
//   pa_sums         the window's live rows (V x the storage width each) and
//                   the center's, their sums written (8 B each);
//   pa_absorb       the live window slots' sums, mag, sq and len (32-40 B),
//                   the positives' rows and owner, stamp and active writes;
//   pa_member_dist  owner of every slot (8 B), the members' rows;
//   pa_mean_argmin  owner of every slot, dist, mag and stamp of the members.
// So an iteration must read the window's live rows once in their storage
// dtype (V bytes a row at the k-mer path's int8 counts) plus O(N) slot
// arrays. At 150k reads of ~1 kb the window holds up to all the live rows,
// 150k x 256 B = 38 MB: 11.5 us at 3.35 TB/s. The design reads only the
// window's rows (slots are sorted by length, so a window is one slot
// range), each once in its storage dtype, widened in registers (no widened
// [N, V] copy); keeps the classifier in registers; reads member rows only
// where owner == c; and runs a persistent grid (kBlocks blocks walk any
// range), so a window of any size is one launch with no host decision.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 528;        // the persistent grid: 4 blocks an SM

// Slots of st (ops/phase_a.py: NPOS ... TICKETS).
constexpr int kNPos = 0, kBest = 1, kLast = 2, kLive = 3, kW0 = 4, kW1 = 5,
              kCount = 6;
constexpr int kScratch = 8;         // pa_window's eight reductions
constexpr int kTicket = 16;         // + 0 pa_window, 1 pa_absorb, 2 the mean

// ops/features.py's flags
constexpr int kFeatLD = 1 << 1, kFeatManhattan = 1 << 2,
              kFeatIntersection = 1 << 4, kFeatPearson = 1 << 5,
              kFeatSimRatio = 1 << 6, kFeatKulczynski2 = 1 << 10;
constexpr int kComboSquared = 1;
constexpr int kMaxSingles = 16;     // ops/phase_a.py:Model checks it

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

// The first max of f1: the greater f1, the least slot among equal f1; a NaN
// anywhere makes the result N, as torch's max propagates NaN.
struct F1Best {
  double f;
  i64 s;
  int nan;
};
struct F1Op {
  __device__ F1Best operator()(F1Best a, F1Best b) const {
    F1Best r = (b.f > a.f || (b.f == a.f && b.s < a.s)) ? b : a;
    r.nan = a.nan | b.nan;
    return r;
  }
};

// The member closest to the mean: the least d, then stamp, then slot.
struct DBest {
  double d;
  i64 stamp;
  i64 s;
};
struct DOp {
  __device__ DBest operator()(DBest a, DBest b) const {
    const bool take = b.d < a.d ||
                      (b.d == a.d && (b.stamp < a.stamp ||
                                      (b.stamp == a.stamp && b.s < a.s)));
    return take ? b : a;
  }
};

__device__ __forceinline__ i64 shfl(i64 v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ F1Best shfl(F1Best v, int o) {
  return {__shfl_xor_sync(0xffffffffu, v.f, o),
          __shfl_xor_sync(0xffffffffu, v.s, o),
          __shfl_xor_sync(0xffffffffu, v.nan, o)};
}
__device__ __forceinline__ DBest shfl(DBest v, int o) {
  return {__shfl_xor_sync(0xffffffffu, v.d, o),
          __shfl_xor_sync(0xffffffffu, v.stamp, o),
          __shfl_xor_sync(0xffffffffu, v.s, o)};
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

// Called by every thread after its block's global writes: true in the block
// that finishes last, which may then read every block's writes. That block
// resets the ticket for the next launch.
__device__ bool last_block(i64* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<u64*>(ticket), 1ull) ==
           static_cast<u64>(gridDim.x - 1);
  __syncthreads();
  if (last && threadIdx.x == 0) *ticket = 0;
  return last;
}

// ---------------------------------------------------------------------------
// pa_window
// ---------------------------------------------------------------------------

// Inclusive slot range [w0, w1] of get_range(lo, hi) of the center at slot
// st[kLast] over the live slots (lengths and bins are non-decreasing over
// slots, so every case is a first or last live slot under a mask):
//   front: the first live slot of the front bin with length >= lo; none: the
//          LAST live slot of that bin; an empty bin: the first live slot;
//   back:  the last live slot of the back bin with length == hi; else its
//          first live slot with length > hi; else its last live slot; an
//          empty bin: the FIRST live slot of the LAST non-empty bin (the
//          truncation quirk), -1 if none. That slot is the maximum of
//          bin * (N + 1) + (N - slot) over the live slots.
__global__ void __launch_bounds__(kThreads)
pa_window_kernel(i64* __restrict__ st, const uint8_t* __restrict__ active,
                 const i64* __restrict__ bin, const i64* __restrict__ len,
                 const i64* __restrict__ lo, const i64* __restrict__ hi,
                 const i64* __restrict__ front_bin,
                 const i64* __restrict__ back_bin, int n) {
  const i64 N = n, last = st[kLast];
  const i64 fb = front_bin[last], lo_c = lo[last];
  const i64 bb = back_bin[last], hi_c = hi[last];
  i64 ge = N, last_f = -1, first = N, eq_last = -1, gt = N, last_b = -1,
      live_last = -1, key = -1;
  // each thread's slots rise, so a first is its first hit, a last its last
  for (i64 s = blockIdx.x * static_cast<i64>(kThreads) + threadIdx.x; s < N;
       s += static_cast<i64>(gridDim.x) * kThreads) {
    if (!active[s]) continue;
    const i64 b = bin[s], L = len[s];
    if (b == fb) {
      if (L >= lo_c) ge = imin(ge, s);
      last_f = s;
    }
    first = imin(first, s);
    if (b == bb) {
      if (L == hi_c) eq_last = s;
      if (L > hi_c) gt = imin(gt, s);
      last_b = s;
    }
    live_last = s;
    key = imax(key, b * (N + 1) + (N - s));
  }
  i64* acc = st + kScratch;
  const i64 r0 = block_reduce(ge, Min()), r1 = block_reduce(last_f, Max());
  const i64 r2 = block_reduce(first, Min()), r3 = block_reduce(eq_last, Max());
  const i64 r4 = block_reduce(gt, Min()), r5 = block_reduce(last_b, Max());
  const i64 r6 = block_reduce(live_last, Max()), r7 = block_reduce(key, Max());
  if (threadIdx.x == 0) {
    atomicMin(acc + 0, r0);
    atomicMax(acc + 1, r1);
    atomicMin(acc + 2, r2);
    atomicMax(acc + 3, r3);
    atomicMin(acc + 4, r4);
    atomicMax(acc + 5, r5);
    atomicMax(acc + 6, r6);
    atomicMax(acc + 7, r7);
  }
  if (!last_block(st + kTicket + 0) || threadIdx.x != 0) return;
  i64 a[8];
  for (int i = 0; i < 8; ++i) a[i] = __ldcg(acc + i);
  const i64 w0 = a[1] >= 0 ? (a[0] < N ? a[0] : a[1]) : a[2];
  const i64 w1 = a[5] >= 0 ? (a[3] >= 0 ? a[3] : (a[4] < N ? a[4] : a[5]))
                           : (a[6] >= 0 ? N - a[7] % (N + 1) : -1);
  st[kW0] = w0;
  st[kW1] = w1;
  st[kLive] = a[2];
  const i64 init[8] = {N, -1, N, -1, N, -1, -1, -1};
  for (int i = 0; i < 8; ++i) acc[i] = init[i];
}

// ---------------------------------------------------------------------------
// pa_sums
// ---------------------------------------------------------------------------

// Products of two counts: 32 bits hold int8 and int16 counts (32767^2 <
// 2^31); int32 counts multiply into 64 bits; int64 counts wrap as torch's.
template <typename T>
struct Wide {
  typedef int type;
};
template <>
struct Wide<int32_t> {
  typedef i64 type;
};
template <>
struct Wide<int64_t> {
  typedef i64 type;
};

// A warp a live slot of [w0, w1]; its lanes stride over the V counts of the
// two rows; sums[s] = man, sums[N + s] = dot (with_dot).
template <typename T>
__global__ void __launch_bounds__(kThreads)
pa_sums_kernel(const i64* __restrict__ st, const uint8_t* __restrict__ active,
               const T* __restrict__ rows, i64 stride, int V, int n,
               int with_dot, i64* __restrict__ sums) {
  typedef typename Wide<T>::type W;
  const i64 w0 = st[kW0], w1 = st[kW1];
  const T* a = rows + st[kLast] * stride;
  const int lane = threadIdx.x & 31;
  const i64 warps = static_cast<i64>(gridDim.x) * kWarps;
  for (i64 s = w0 + blockIdx.x * static_cast<i64>(kWarps) + (threadIdx.x >> 5);
       s <= w1; s += warps) {
    if (!active[s]) continue;
    const T* b = rows + s * stride;
    i64 man = 0, dot = 0;
    for (int v = lane; v < V; v += 32) {
      const W x = a[v], y = b[v];
      man += x > y ? x - y : y - x;
      dot += static_cast<i64>(x) * static_cast<i64>(y);
    }
    man = warp_reduce(man, Sum());
    if (with_dot) dot = warp_reduce(dot, Sum());
    if (lane == 0) {
      sums[s] = man;
      if (with_dot) sums[n + s] = dot;
    }
  }
}

// ---------------------------------------------------------------------------
// pa_absorb
// ---------------------------------------------------------------------------

// The classifier, packed by ops/phase_a.py:Model:
//   spec (int32): S, J, singles[S], is_sim[S], kinds[J], off[J + 1], idx[..]
//   coef (f64):   V, mins[S], spans[S], weights[J + 1]
// Scorer.__call__ for one pair (a: the center, b: the slot), op for op:
// -> score >= 0, and f1 (the first combo's product).
__device__ bool classify(const int* spec, const double* coef, double man,
                         double dot, double mag_a, double mag_b, double sq_a,
                         double sq_b, double len_a, double len_b,
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
  double norm[kMaxSingles];
  for (int i = 0; i < S; ++i) {
    double v;
    switch (singles[i]) {
      case kFeatLD:
        v = fabs(__dsub_rn(len_a, len_b));
        break;
      case kFeatManhattan:
        v = man;
        break;
      case kFeatIntersection: {
        const double min_sum =
            __ddiv_rn(__dsub_rn(__dadd_rn(mag_a, mag_b), man), 2.0);
        v = __ddiv_rn(__dmul_rn(2.0, min_sum), __dadd_rn(mag_a, mag_b));
        break;
      }
      case kFeatKulczynski2: {
        const double ap = __ddiv_rn(mag_a, V), aq = __ddiv_rn(mag_b, V);
        const double min_sum =
            __ddiv_rn(__dsub_rn(__dadd_rn(mag_a, mag_b), man), 2.0);
        const double coeff = __ddiv_rn(__dmul_rn(V, __dadd_rn(ap, aq)),
                                       __dmul_rn(__dmul_rn(2.0, ap), aq));
        v = __dmul_rn(coeff, min_sum);
        break;
      }
      case kFeatSimRatio: {
        double norm2 = __dsub_rn(__dadd_rn(sq_a, sq_b), __dmul_rn(2.0, dot));
        norm2 = norm2 < 0.0 ? 0.0 : norm2;          // clamp(min=0); NaN stays
        v = __ddiv_rn(dot, __dadd_rn(dot, __dsqrt_rn(norm2)));
        break;
      }
      case kFeatPearson: {
        const double ap = floor(__dadd_rn(__ddiv_rn(mag_a, V), 0.5));
        const double aq = floor(__dadd_rn(__ddiv_rn(mag_b, V), 0.5));
        const double np_ =
            __dadd_rn(__dsub_rn(sq_a, __dmul_rn(__dmul_rn(2.0, ap), mag_a)),
                      __dmul_rn(__dmul_rn(V, ap), ap));
        const double nq_ =
            __dadd_rn(__dsub_rn(sq_b, __dmul_rn(__dmul_rn(2.0, aq), mag_b)),
                      __dmul_rn(__dmul_rn(V, aq), aq));
        const double dotc = __dadd_rn(
            __dsub_rn(__dsub_rn(dot, __dmul_rn(ap, mag_b)),
                      __dmul_rn(aq, mag_a)),
            __dmul_rn(__dmul_rn(V, ap), aq));
        double p = __dmul_rn(np_, nq_);
        p = p < 0.5 ? 0.5 : p;                      // clamp(min=0.5)
        v = __ddiv_rn(dotc, __dsqrt_rn(p));
        break;
      }
      default:
        v = __longlong_as_double(0x7ff8000000000000LL);
    }
    const double nv = __ddiv_rn(__dsub_rn(v, mins[i]), spans[i]);
    norm[i] = is_sim[i] ? nv : __dsub_rn(1.0, nv);
  }
  double score = weights[0], f1 = 0.0;
  for (int j = 0; j < J; ++j) {
    double prod = 1.0;
    for (int e = off[j]; e < off[j + 1]; ++e) {
      const double c = norm[idx[e]];
      prod = __dmul_rn(prod, kinds[j] == kComboSquared ? __dmul_rn(c, c) : c);
    }
    if (j == 0) f1 = prod;
    score = __dadd_rn(score, __dmul_rn(weights[j + 1], prod));
  }
  *f1_out = f1;
  return score >= 0.0;
}

// A thread a live slot of [w0, w1], in block-wide tiles; each tile's
// positives are listed in shared memory and the block adds their rows into
// sumvec with int64 atomics. Per-block partials (part: f1 bits, slot, NaN,
// n_pos; kBlocks each) are combined by the last block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pa_absorb_kernel(i64* __restrict__ st, const i64* __restrict__ sums,
                 int with_dot, const int* __restrict__ spec_g, int n_spec,
                 const double* __restrict__ coef_g, int n_coef,
                 const double* __restrict__ mag, const double* __restrict__ sq,
                 const double* __restrict__ lenf, i64* __restrict__ owner,
                 i64* __restrict__ stamp, uint8_t* __restrict__ active,
                 const T* __restrict__ rows, i64 stride, int V,
                 i64* __restrict__ sumvec, int n, i64 c, i64 t,
                 i64* __restrict__ part) {
  extern __shared__ double model[];
  __shared__ i64 pos_list[kThreads];
  __shared__ int n_list;
  double* coef = model;
  int* spec = reinterpret_cast<int*>(model + n_coef);
  for (int i = threadIdx.x; i < n_coef; i += kThreads) coef[i] = coef_g[i];
  for (int i = threadIdx.x; i < n_spec; i += kThreads) spec[i] = spec_g[i];
  const i64 N = n, w0 = st[kW0], w1 = st[kW1], last = st[kLast];
  const double mag_a = mag[last], sq_a = sq[last], len_a = lenf[last];
  F1Best best = {-INFINITY, N, 0};
  i64 npos = 0;
  for (i64 base = w0 + blockIdx.x * static_cast<i64>(kThreads); base <= w1;
       base += static_cast<i64>(gridDim.x) * kThreads) {
    if (threadIdx.x == 0) n_list = 0;
    __syncthreads();                // also: the model is in shared memory
    const i64 s = base + threadIdx.x;
    if (s <= w1 && active[s]) {
      double f1;
      const bool pos = classify(
          spec, coef, static_cast<double>(sums[s]),
          with_dot ? static_cast<double>(sums[N + s]) : 0.0, mag_a, mag[s],
          sq_a, sq[s], len_a, lenf[s], &f1);
      if (f1 != f1)
        best.nan = 1;
      else if (f1 > best.f || (f1 == best.f && s < best.s))
        best = {f1, s, best.nan};
      if (pos) {
        owner[s] = c;
        stamp[s] = t;
        active[s] = 0;
        ++npos;
        pos_list[atomicAdd(&n_list, 1)] = s;
      }
    }
    __syncthreads();
    for (int i = 0; i < n_list; ++i) {
      const T* r = rows + pos_list[i] * stride;
      for (int v = threadIdx.x; v < V; v += kThreads)
        atomicAdd(reinterpret_cast<u64*>(sumvec + v),
                  static_cast<u64>(static_cast<i64>(r[v])));
    }
    __syncthreads();                // before the next tile resets n_list
  }
  best = block_reduce(best, F1Op());
  npos = block_reduce(npos, Sum());
  const int G = gridDim.x;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = __double_as_longlong(best.f);
    part[G + blockIdx.x] = best.s;
    part[2 * G + blockIdx.x] = best.nan;
    part[3 * G + blockIdx.x] = npos;
  }
  if (!last_block(st + kTicket + 1)) return;
  best = {-INFINITY, N, 0};
  npos = 0;
  for (int b = threadIdx.x; b < G; b += kThreads) {
    best = F1Op()(best, {__longlong_as_double(__ldcg(part + b)),
                         __ldcg(part + G + b),
                         static_cast<int>(__ldcg(part + 2 * G + b))});
    npos += __ldcg(part + 3 * G + b);
  }
  best = block_reduce(best, F1Op());
  npos = block_reduce(npos, Sum());
  if (threadIdx.x == 0) {
    st[kNPos] = npos;
    st[kBest] = best.nan ? N : best.s;
    st[kCount] += npos;
  }
}

// ---------------------------------------------------------------------------
// pa_member_dist
// ---------------------------------------------------------------------------

// A warp takes 32 slots at a time and serves each member among them (owner
// == c) with all its lanes: dist[s] = 2 * sum_v min(h[s, v], cw[v]), cw =
// floor(sumvec / count) divided in float64 as mean_floor does. Block 0 also
// writes dist[N] = sum_v cw[v] (integers below 2^53: exact in any order).
template <typename T>
__global__ void __launch_bounds__(kThreads)
pa_member_dist_kernel(const i64* __restrict__ st, const i64* __restrict__ owner,
                      i64 c, const T* __restrict__ rows, i64 stride, int V,
                      const i64* __restrict__ sumvec, int n,
                      i64* __restrict__ dist) {
  const double count = static_cast<double>(st[kCount]);
  const int lane = threadIdx.x & 31;
  const i64 warps = static_cast<i64>(gridDim.x) * kWarps;
  for (i64 base = (blockIdx.x * static_cast<i64>(kWarps) + (threadIdx.x >> 5))
                  * 32;
       base < n; base += warps * 32) {
    const i64 s = base + lane;
    unsigned members = __ballot_sync(0xffffffffu, s < n && owner[s] == c);
    while (members) {
      const i64 m = base + __ffs(members) - 1;
      members &= members - 1;
      const T* r = rows + m * stride;
      i64 acc = 0;
      for (int v = lane; v < V; v += 32) {
        const i64 cw = static_cast<i64>(
            floor(__ddiv_rn(static_cast<double>(sumvec[v]), count)));
        const i64 x = r[v];
        acc += x < cw ? x : cw;
      }
      acc = warp_reduce(acc, Sum());
      if (lane == 0) dist[m] = 2 * acc;
    }
  }
  if (blockIdx.x != 0) return;
  i64 cw_sum = 0;
  for (int v = threadIdx.x; v < V; v += kThreads)
    cw_sum += static_cast<i64>(
        floor(__ddiv_rn(static_cast<double>(sumvec[v]), count)));
  cw_sum = block_reduce(cw_sum, Sum());
  if (threadIdx.x == 0) dist[n] = cw_sum;
}

// ---------------------------------------------------------------------------
// pa_mean_argmin
// ---------------------------------------------------------------------------

// frac = dist / (mag + cw_sum), d = 10000 * (1 - frac * frac) for each
// member; the least (d, stamp, slot) becomes st[kLast]. Per-block partials
// (part: d bits, stamp, slot) are combined by the last block.
__global__ void __launch_bounds__(kThreads)
pa_mean_argmin_kernel(i64* __restrict__ st, const i64* __restrict__ dist,
                      const double* __restrict__ mag,
                      const i64* __restrict__ owner,
                      const i64* __restrict__ stamp, i64 c, int n,
                      i64* __restrict__ part) {
  const double cw_sum = static_cast<double>(dist[n]);
  const DBest none = {INFINITY, 0x7fffffffffffffffLL, n};
  DBest best = none;
  for (i64 s = blockIdx.x * static_cast<i64>(kThreads) + threadIdx.x; s < n;
       s += static_cast<i64>(gridDim.x) * kThreads) {
    if (owner[s] != c) continue;
    const double frac =
        __ddiv_rn(static_cast<double>(dist[s]), __dadd_rn(mag[s], cw_sum));
    const double d =
        __dmul_rn(10000.0, __dsub_rn(1.0, __dmul_rn(frac, frac)));
    best = DOp()(best, {d, stamp[s], s});
  }
  best = block_reduce(best, DOp());
  const int G = gridDim.x;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = __double_as_longlong(best.d);
    part[G + blockIdx.x] = best.stamp;
    part[2 * G + blockIdx.x] = best.s;
  }
  if (!last_block(st + kTicket + 2)) return;
  best = none;
  for (int b = threadIdx.x; b < G; b += kThreads)
    best = DOp()(best, {__longlong_as_double(__ldcg(part + b)),
                        __ldcg(part + G + b), __ldcg(part + 2 * G + b)});
  best = block_reduce(best, DOp());
  if (threadIdx.x == 0) st[kLast] = best.s;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points: launch on the caller's stream, return cudaGetLastError().
// `width` is the rows' element size in bytes (1, 2, 4 or 8).
// ---------------------------------------------------------------------------

extern "C" int mc_pa_window(void* st, const void* active, const void* bin,
                            const void* len, const void* lo, const void* hi,
                            const void* front_bin, const void* back_bin,
                            int n, void* stream) {
  pa_window_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<i64*>(st), static_cast<const uint8_t*>(active),
      static_cast<const i64*>(bin), static_cast<const i64*>(len),
      static_cast<const i64*>(lo), static_cast<const i64*>(hi),
      static_cast<const i64*>(front_bin), static_cast<const i64*>(back_bin),
      n);
  return cudaGetLastError();
}

extern "C" int mc_pa_sums(const void* st, const void* active, const void* rows,
                          long long stride, int V, int width, int n,
                          int with_dot, void* sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64* st_ = static_cast<const i64*>(st);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  i64* out = static_cast<i64*>(sums);
  switch (width) {
    case 1:
      pa_sums_kernel<<<kBlocks, kThreads, 0, s>>>(
          st_, act, static_cast<const int8_t*>(rows), stride, V, n, with_dot,
          out);
      break;
    case 2:
      pa_sums_kernel<<<kBlocks, kThreads, 0, s>>>(
          st_, act, static_cast<const int16_t*>(rows), stride, V, n, with_dot,
          out);
      break;
    case 4:
      pa_sums_kernel<<<kBlocks, kThreads, 0, s>>>(
          st_, act, static_cast<const int32_t*>(rows), stride, V, n, with_dot,
          out);
      break;
    case 8:
      pa_sums_kernel<<<kBlocks, kThreads, 0, s>>>(
          st_, act, static_cast<const int64_t*>(rows), stride, V, n, with_dot,
          out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
static void launch_absorb(cudaStream_t s, size_t smem, void* st,
                          const void* sums, int with_dot, const void* spec,
                          int n_spec, const void* coef, int n_coef,
                          const void* mag, const void* sq, const void* lenf,
                          void* owner, void* stamp, void* active,
                          const void* rows, long long stride, int V,
                          void* sumvec, int n, long long c, long long t,
                          void* part) {
  pa_absorb_kernel<T><<<kBlocks, kThreads, smem, s>>>(
      static_cast<i64*>(st), static_cast<const i64*>(sums), with_dot,
      static_cast<const int*>(spec), n_spec, static_cast<const double*>(coef),
      n_coef, static_cast<const double*>(mag), static_cast<const double*>(sq),
      static_cast<const double*>(lenf), static_cast<i64*>(owner),
      static_cast<i64*>(stamp), static_cast<uint8_t*>(active),
      static_cast<const T*>(rows), stride, V, static_cast<i64*>(sumvec), n, c,
      t, static_cast<i64*>(part));
}

extern "C" int mc_pa_absorb(void* st, const void* sums, int with_dot,
                            const void* spec, int n_spec, const void* coef,
                            int n_coef, const void* mag, const void* sq,
                            const void* lenf, void* owner, void* stamp,
                            void* active, const void* rows, long long stride,
                            int V, int width, void* sumvec, int n,
                            long long c, long long t, void* part,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = n_coef * sizeof(double) + n_spec * sizeof(int);
#define MC_ABSORB(T)                                                         \
  launch_absorb<T>(s, smem, st, sums, with_dot, spec, n_spec, coef, n_coef, \
                   mag, sq, lenf, owner, stamp, active, rows, stride, V,     \
                   sumvec, n, c, t, part)
  switch (width) {
    case 1: MC_ABSORB(int8_t); break;
    case 2: MC_ABSORB(int16_t); break;
    case 4: MC_ABSORB(int32_t); break;
    case 8: MC_ABSORB(int64_t); break;
    default: return cudaErrorInvalidValue;
  }
#undef MC_ABSORB
  return cudaGetLastError();
}

extern "C" int mc_pa_member_dist(const void* st, const void* owner,
                                 long long c, const void* rows,
                                 long long stride, int V, int width,
                                 const void* sumvec, int n, void* dist,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64* st_ = static_cast<const i64*>(st);
  const i64* own = static_cast<const i64*>(owner);
  const i64* sv = static_cast<const i64*>(sumvec);
  i64* out = static_cast<i64*>(dist);
  switch (width) {
    case 1:
      pa_member_dist_kernel<<<kBlocks, kThreads, 0, s>>>(
          st_, own, c, static_cast<const int8_t*>(rows), stride, V, sv, n,
          out);
      break;
    case 2:
      pa_member_dist_kernel<<<kBlocks, kThreads, 0, s>>>(
          st_, own, c, static_cast<const int16_t*>(rows), stride, V, sv, n,
          out);
      break;
    case 4:
      pa_member_dist_kernel<<<kBlocks, kThreads, 0, s>>>(
          st_, own, c, static_cast<const int32_t*>(rows), stride, V, sv, n,
          out);
      break;
    case 8:
      pa_member_dist_kernel<<<kBlocks, kThreads, 0, s>>>(
          st_, own, c, static_cast<const int64_t*>(rows), stride, V, sv, n,
          out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int mc_pa_mean_argmin(void* st, const void* dist, const void* mag,
                                 const void* owner, const void* stamp,
                                 long long c, int n, void* part,
                                 void* stream) {
  pa_mean_argmin_kernel<<<kBlocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<i64*>(st), static_cast<const i64*>(dist),
      static_cast<const double*>(mag), static_cast<const i64*>(owner),
      static_cast<const i64*>(stamp), c, n, static_cast<i64*>(part));
  return cudaGetLastError();
}
