// Phase B's update+merge iteration for Hopper (sm_90a): four kernels over
// the member pool and the centers, with the state on the device.
//
// Replaces, as XLA and not Pallas, the fused Phase B of
// meshclust_tpu/core/classify.py:563 _build_phaseb: one lax.scan over the
// iterations whose body runs the update's band of offsets (cls_body :644),
// the mean and distance_d (dist_body :680), the pick (pos_body :727), the
// move (:742) and the merge with its pointer jumps and compaction
// (:745-787). The port's host loop (core/classify.py:DeviceBackend.
// phase_b_loop) launches, an iteration:
//   pb_band   for each member m and offset o in [-delta, delta], center
//             jc = assign[m] + o: man and dot of the center's row against
//             the member's, the float64 classifier (a: the center, b: the
//             member, common.cuh:classify), a bit a positive (2 delta + 1
//             bits a member, in words of 32), and the positive rows and
//             their count added into sc [C, V + 1] as exact int64; first it
//             maps assign through the last merge's remap and resets best_d
//             and best_pos;
//   pb_dist   for each positive (m, o): cw = floor(sums / max(count, 1)) of
//             its center, dist = 2 * sum min(h, cw), frac = dist / (mag +
//             sum cw), d = 10000 * (1 - frac * frac) (two roundings, no
//             FMA), d kept in dstore [M, 2 delta + 1], and the least d of
//             each center (best_d);
//   pb_pick   for each positive whose d is its center's least: the least
//             pool position (best_pos); and sc zeroed for the next band;
//   pb_merge  the move (a center takes its best member), then for each
//             center i the first max of f1 over its candidates i + 1 ..
//             i + delta (a: the candidate, b: center i), strictly above
//             DBL_MIN, its target t (t_hist's row), the merge chains
//             followed to their ends, the kept centers compacted to a dense
//             prefix, and remap = the new slot of each old center's chain
//             end, which the next pb_band applies to assign.
// Under a mesh (parallel/dist) each rank's pb_band, pb_dist and pb_pick take
// its block of the pool, and the host sums sc, then takes the minima of
// best_d and of best_pos across ranks between them; every rank runs
// pb_merge on the same centers.
//
// Bit-equality with the plain steps (ops/phase_b.py): every sum is an
// integer (int64 atomics, or a block's sums, exact in any order); best_d is
// the least of non-negative doubles, whose bit patterns order as int64, so a
// 64-bit atomicMin on them is exact; best_pos is an int64 atomicMin; every
// float64 operation is an explicit round-to-nearest intrinsic in the plain
// steps' order (nvcc contracts a * b + c into an FMA by default); the merge
// chains' ends are a fixpoint, which the plain steps' ceil(log2 C) jumps
// also reach.
//
// Bound: bytes. An iteration must read the members' rows twice (the band's
// classifier, the distances), each center's row (L2-resident: C rows), the
// members' assign, bits and, for the positives, dstore, and write sc. At 1M
// reads (V = 256 int8 counts, 12k centers) that is ~2 x 256 MB: ~0.15 ms
// at 3.35 TB/s; the plain steps built [M, V] int64 temporaries at every
// offset (2 GB at 1M). The design reads each member row once a kernel in
// its storage dtype (pieces of 16 bytes, byte SIMD for int8, widened in
// registers), keeps the member's piece in a register over its 2 delta + 1
// centers, whose rows a block's tile shares in L1 (a tile's members belong
// to a few neighbouring centers); lists a tile's positives offset by
// offset in member order, so that equal centers form runs, and adds a run's
// rows with one atomic a column; divides a center's mean once a run into
// shared memory and serves the run's members from it (common.cuh:
// tile_dist); and does the merge's C-sized steps in the last block of
// pb_merge, with no host round trip.
#include "common.cuh"

namespace {

// Members of a block's tile in pb_band (one a thread of the first kTile
// when listing the positives): half a block, so that 15k members fill 118
// blocks and a run re-reads at most 128 rows. pb_dist's tile is a whole
// block: a run divides its center's mean once, so its tiles hold fewer,
// longer runs.
constexpr int kTile = 128;
constexpr int kDistTile = kThreads;
// Slots of pb_merge's scratch (ops/phase_b.py: scratch_len): its ticket,
// then c_new (the moved centers), T (the chains' ends) and NP (the kept
// centers' new slots), C int64 each.
constexpr int kTicket = 0, kScratchHead = 1;
// DBL_MIN, the floor of the merge's best f1 (Trainer.cpp:132-135).
constexpr double kDblMin = 2.2250738585072014e-308;

// The positions of the threads with p set, in thread order, written to
// out[0, total); -> total, in every thread.
__device__ int block_compact(bool p, int val, int* out) {
  __shared__ int wc[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, p);
  if (lane == 0) wc[warp] = __popc(b);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? wc[w] : 0;
    total += wc[w];
  }
  if (p) out[base + __popc(b & ((1u << lane) - 1u))] = val;
  __syncthreads();
  return total;
}

// The inclusive sum of x over the threads in thread order; *total, the
// block's sum, in every thread.
__device__ int block_scan(int x, int* total) {
  __shared__ int ws[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += n;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  int base = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? ws[w] : 0;
    sum += ws[w];
  }
  __syncthreads();
  *total = sum;
  return base + x;
}

// The positives of a tile at one offset, listed (values from val_of) in
// member order in list[0, L), and the starts of the runs of equal centers
// in runs[0, R], runs[R] = L; -> R (0 when L = 0). asg[t] is member t's
// center (tile-local t).
__device__ int tile_runs(bool p, int val, const i64* asg, int base,
                         int* list, int* runs) {
  const int tid = threadIdx.x;
  const int L = block_compact(p, val, list);
  if (L == 0) return 0;
  bool start = false;
  if (tid < L)
    start = tid == 0 || asg[list[tid] - base] != asg[list[tid - 1] - base];
  const int R = block_compact(start, tid, runs);
  if (tid == 0) runs[R] = L;
  __syncthreads();
  return R;
}

// The classifier's packed arrays (ops/phase_a.py:Model) into shared memory.
__device__ void stage_model(double* model, const int* spec_g, int n_spec,
                            const double* coef_g, int n_coef) {
  int* spec = reinterpret_cast<int*>(model + n_coef);
  for (int i = threadIdx.x; i < n_coef; i += kThreads) model[i] = coef_g[i];
  for (int i = threadIdx.x; i < n_spec; i += kThreads) spec[i] = spec_g[i];
}

// man and dot of row a against row b over the group of `lanes` lanes (in
// every lane of the group): nv pieces of VEC bytes. Short rows (nv <=
// lanes) pass b's piece, which the caller holds in a register; long rows
// (lanes = 32) read both rows' pieces.
template <typename T, int VEC>
__device__ __forceinline__ void pair_sums(const char* a_row,
                                          const char* b_row,
                                          const Piece<VEC>& b_piece, bool ok,
                                          int nv, int sub, int lanes, i64& man,
                                          i64& dot) {
  typedef typename Acc<T>::type A;
  if (nv <= lanes) {
    Piece<VEC> a = {};
    if (ok && sub < nv) a = load_center<VEC>(a_row + sub * VEC);
    A m = 0, d = 0;
    add_piece<T, VEC>(a, b_piece, m, d);
    man = group_sum(m, lanes);
    dot = group_sum(d, lanes);
    return;
  }
  i64 m64 = 0, d64 = 0;
  for (int p = sub; p < nv; p += 32) {
    Piece<VEC> a = {}, b = {};
    if (ok) {
      a = load_center<VEC>(a_row + static_cast<i64>(p) * VEC);
      b = load_center<VEC>(b_row + static_cast<i64>(p) * VEC);
    }
    A m = 0, d = 0;
    add_piece<T, VEC>(a, b, m, d);
    m64 += m;
    d64 += d;
  }
  man = group_sum(m64, 32);
  dot = group_sum(d64, 32);
}

// The lanes a row's pieces take: a power of two, at least nv up to 32.
__device__ __forceinline__ int row_lanes(int nv) {
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  return lanes;
}

// ---------------------------------------------------------------------------
// pb_band
// ---------------------------------------------------------------------------

// A block a tile of kTile members. It maps the tile's assign through remap
// (written back), and its threads reset best_d and best_pos in a grid
// stride. Then a group of `lanes` lanes a member walks its 2 delta + 1
// offsets: the member's piece stays in a register, the center's comes
// through L1; after each group_sum the lane whose number is the offset's
// (mod lanes) keeps man and dot, and after `lanes` offsets each such lane
// classifies its own, so a group classifies up to `lanes` offsets at once;
// a ballot gathers the group's bits into the member's words. Then, offset
// by offset, the tile's positives are listed in member order (tile_runs)
// and each run of equal centers adds its rows and count into sc with one
// int64 atomic a column (none for a zero).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pb_band_kernel(const char* __restrict__ rows, i64 pitch,
               const char* __restrict__ hist, i64 hpitch, int nv, int V,
               const i64* __restrict__ m_idx,
               const uint8_t* __restrict__ m_valid, int M,
               i64* __restrict__ assign, const i64* __restrict__ remap,
               const i64* __restrict__ c_idx,
               const uint8_t* __restrict__ c_valid, int C,
               const double* __restrict__ mag, const double* __restrict__ sq,
               const double* __restrict__ lenf, const int* __restrict__ spec_g,
               int n_spec, const double* __restrict__ coef_g, int n_coef,
               int delta, int W, unsigned* __restrict__ bits,
               i64* __restrict__ sc, double* __restrict__ best_d,
               i64* __restrict__ best_pos, i64 m_all) {
  extern __shared__ double model[];
  __shared__ i64 asg[kTile];
  __shared__ int list[kTile];
  __shared__ int runs[kTile + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = 2 * delta + 1;
  stage_model(model, spec_g, n_spec, coef_g, n_coef);
  const double* coef = model;
  const int* spec = reinterpret_cast<const int*>(model + n_coef);
  for (i64 j = blockIdx.x * static_cast<i64>(kThreads) + tid; j < C;
       j += static_cast<i64>(gridDim.x) * kThreads) {
    best_d[j] = INFINITY;
    best_pos[j] = m_all;
  }
  const i64 m0 = blockIdx.x * static_cast<i64>(kTile);
  if (tid < kTile) {
    const i64 m = m0 + tid;
    i64 a = -1;
    if (m < M) {
      a = remap[assign[m]];
      assign[m] = a;
    }
    asg[tid] = a;
  }
  __syncthreads();                    // also: the model is in shared memory

  const int lanes = row_lanes(nv);
  const int sub = lane & (lanes - 1), grp = lane / lanes;
  const int groups = 32 / lanes;
  const unsigned gmask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  for (int g0 = warp * groups; g0 < kTile; g0 += kWarps * groups) {
    const int g = g0 + grp;
    const i64 m = m0 + g;
    const bool have = m < M;
    const bool mv = have && (m_valid == nullptr || m_valid[m]);
    const i64 a_m = asg[g];
    const i64 pt = have ? m_idx[m] : 0;
    const char* b_row = rows + (have ? m : 0) * pitch;
    // through L1: the run adds below read the tile's rows again
    Piece<VEC> b = {};
    if (nv <= lanes && have && sub < nv)
      b = load_center<VEC>(b_row + sub * VEC);
    const double mag_b = mag[pt], sq_b = sq[pt], len_b = lenf[pt];
    i64 my_man = 0, my_dot = 0, my_a = -1;
    unsigned word = 0;
    int shift = 0, wi = 0;
    for (int oi = 0; oi < K; ++oi) {
      const i64 j = a_m + oi - delta;
      const bool ok = mv && j >= 0 && j < C && c_valid[j];
      const i64 a = ok ? c_idx[j] : 0;
      i64 man, dot;
      pair_sums<T, VEC>(hist + a * hpitch, b_row, b, ok, nv, sub, lanes, man,
                        dot);
      const int at = oi & (lanes - 1);
      if (sub == at) {
        my_man = man;
        my_dot = dot;
        my_a = ok ? a : -1;
      }
      if (at != lanes - 1 && oi != K - 1) continue;
      bool pos = false;
      if (sub <= at && my_a >= 0) {
        double f1;
        pos = classify(spec, coef, static_cast<double>(my_man),
                       static_cast<double>(my_dot), mag[my_a], mag_b,
                       sq[my_a], sq_b, lenf[my_a], len_b, &f1);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, pos);
      word |= ((ballot >> (grp * lanes)) & gmask) << shift;
      shift += lanes;
      if (shift == 32 || oi == K - 1) {
        if (have && sub == 0) bits[m * W + wi] = word;
        word = 0;
        shift = 0;
        ++wi;
      }
    }
  }
  __syncthreads();                    // the tile's bits are written

  const i64 Vp = static_cast<i64>(V) + 1;
  for (int oi = 0; oi < K; ++oi) {
    const i64 m = m0 + tid;
    const bool p = tid < kTile && m < M &&
                   ((bits[m * W + (oi >> 5)] >> (oi & 31)) & 1u);
    const int R = tile_runs(p, tid, asg, 0, list, runs);
    for (int r = 0; r < R; ++r) {
      const int p0 = runs[r], p1 = runs[r + 1];
      i64* out = sc + (asg[list[p0]] + oi - delta) * Vp;
      for (int v = tid; v <= V; v += kThreads) {
        i64 acc = p1 - p0;
        if (v < V) {
          acc = 0;
          for (int q = p0; q < p1; ++q)
            acc += *reinterpret_cast<const T*>(
                rows + (m0 + list[q]) * pitch + static_cast<i64>(v) * sizeof(T));
        }
        if (acc)
          atomicAdd(reinterpret_cast<u64*>(out + v), static_cast<u64>(acc));
      }
    }
    __syncthreads();                  // before the next offset's lists
  }
}

// ---------------------------------------------------------------------------
// pb_dist
// ---------------------------------------------------------------------------

// A block a tile of kDistTile members. Offset by offset it lists the tile's
// positives (global member numbers) in member order, and for each run of
// equal centers divides the center's mean once into shared memory and
// serves the run's members from it (common.cuh:tile_dist: their distances
// in dl, and sum cw), then takes d for each, keeps it in dstore, and adds
// the run's least d into best_d[center] with one 64-bit atomicMin.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pb_dist_kernel(const char* __restrict__ rows, i64 pitch, int V,
               const i64* __restrict__ m_idx, int M,
               const i64* __restrict__ assign, const double* __restrict__ mag,
               int delta, int W, const unsigned* __restrict__ bits,
               const i64* __restrict__ sc, double* __restrict__ dstore,
               double* __restrict__ best_d) {
  __shared__ __align__(16) char cw_s[kCwBytes];
  __shared__ i64 asg[kDistTile];
  __shared__ i64 dl[kDistTile];
  __shared__ int list[kDistTile];
  __shared__ int runs[kDistTile + 1];
  __shared__ double cw_total;
  const int tid = threadIdx.x;
  const int K = 2 * delta + 1;
  const i64 Vp = static_cast<i64>(V) + 1;
  const int m0 = blockIdx.x * kDistTile;
  asg[tid] = m0 + tid < M ? assign[m0 + tid] : -1;
  __syncthreads();
  for (int oi = 0; oi < K; ++oi) {
    const int m = m0 + tid;
    const bool p = m < M && ((bits[static_cast<i64>(m) * W + (oi >> 5)] >>
                              (oi & 31)) & 1u);
    const int R = tile_runs(p, m, asg, m0, list, runs);
    for (int r = 0; r < R; ++r) {
      const int p0 = runs[r], p1 = runs[r + 1];
      const i64 jc = asg[list[p0] - m0] + oi - delta;
      const i64* srow = sc + jc * Vp;
      const i64 cnt = srow[V];
      const double count = static_cast<double>(cnt > 1 ? cnt : 1);
      const i64 sv0 = tid < V ? srow[tid] : 0;
      i64 cw_sum = tile_dist<T, VEC>(rows, pitch, V, srow, sv0, count,
                                     list + p0, p1 - p0, cw_s, dl + p0,
                                     nullptr);
      cw_sum = block_reduce(cw_sum, Sum());
      if (tid == 0) cw_total = static_cast<double>(cw_sum);
      __syncthreads();
      i64 least = 0x7fffffffffffffffLL;
      for (int i = p0 + tid; i < p1; i += kThreads) {
        const i64 mm = list[i];
        const double frac = __ddiv_rn(static_cast<double>(dl[i]),
                                      __dadd_rn(mag[m_idx[mm]], cw_total));
        const double d =
            __dmul_rn(10000.0, __dsub_rn(1.0, __dmul_rn(frac, frac)));
        dstore[mm * K + oi] = d;
        least = imin(least, __double_as_longlong(d));
      }
      least = block_reduce(least, Min());
      if (tid == 0)
        atomicMin(reinterpret_cast<u64*>(best_d + jc),
                  static_cast<u64>(least));
      __syncthreads();                // before the next run's mean
    }
  }
}

// ---------------------------------------------------------------------------
// pb_pick
// ---------------------------------------------------------------------------

// A thread a member: each positive whose d equals its center's least puts
// the member's pool position into best_pos[center] (int64 atomicMin). The
// grid also zeroes sc (sc_len int64) for the next band.
__global__ void __launch_bounds__(kThreads)
pb_pick_kernel(int M, const i64* __restrict__ assign, int delta, int W,
               const unsigned* __restrict__ bits,
               const double* __restrict__ dstore,
               const double* __restrict__ best_d, i64* __restrict__ best_pos,
               i64 goff, i64* __restrict__ sc, i64 sc_len) {
  const i64 gid = blockIdx.x * static_cast<i64>(kThreads) + threadIdx.x;
  const i64 stride = static_cast<i64>(gridDim.x) * kThreads;
  for (i64 e = gid; e < sc_len; e += stride) sc[e] = 0;
  if (gid >= M) return;
  const int K = 2 * delta + 1;
  const i64 a = assign[gid];
  for (int w = 0; w < W; ++w) {
    unsigned word = bits[gid * W + w];
    while (word) {
      const int oi = 32 * w + __ffs(word) - 1;
      word &= word - 1;
      const i64 jc = a + oi - delta;
      if (dstore[gid * K + oi] == best_d[jc])
        atomicMin(reinterpret_cast<long long*>(best_pos + jc), goff + gid);
    }
  }
}

// ---------------------------------------------------------------------------
// pb_merge
// ---------------------------------------------------------------------------

// The center a slot holds after the move: its best member where it has one
// and is valid.
__device__ __forceinline__ i64 moved(i64 j, const i64* best_pos,
                                     const i64* m_all, i64 M_all,
                                     const i64* c_idx,
                                     const uint8_t* c_valid) {
  const i64 bp = best_pos[j];
  return bp < M_all && c_valid[j] ? m_all[bp] : c_idx[j];
}

// A group of `lanes` lanes a center i: the moved center's piece in a
// register, the candidates i + 1 .. i + delta as pb_band walks its offsets
// (a lane classifies each), then the group takes the first max of f1 over
// the offsets in order (strict >, from DBL_MIN), and writes t = the target
// (i when none, or when i is not valid) into t_row and the moved center
// into c_new. The last block (ticket) then follows each t to its chain's
// end (T, in place until nothing changes), scans the kept centers (valid,
// t = i) into their new slots (NP), writes remap = NP[T], moves the kept
// centers to their slots, zeroes the slots past them and sets c_valid to
// the dense prefix.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pb_merge_kernel(const char* __restrict__ hist, i64 hpitch, int nv, int C,
                i64* __restrict__ c_idx, uint8_t* __restrict__ c_valid,
                const i64* __restrict__ best_pos,
                const i64* __restrict__ m_all, i64 M_all,
                const double* __restrict__ mag, const double* __restrict__ sq,
                const double* __restrict__ lenf,
                const int* __restrict__ spec_g, int n_spec,
                const double* __restrict__ coef_g, int n_coef, int delta,
                i64* __restrict__ t_row, i64* __restrict__ remap,
                i64* __restrict__ scr) {
  extern __shared__ double model[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  i64* c_new = scr + kScratchHead;
  i64* Tc = c_new + C;
  i64* NP = Tc + C;
  stage_model(model, spec_g, n_spec, coef_g, n_coef);
  const double* coef = model;
  const int* spec = reinterpret_cast<const int*>(model + n_coef);
  __syncthreads();
  const int lanes = row_lanes(nv);
  const int sub = lane & (lanes - 1), grp = lane / lanes;
  const int groups = 32 / lanes;
  const i64 i = blockIdx.x * static_cast<i64>(kWarps * groups) +
                warp * groups + grp;
  const bool have = i < C;
  const bool vi = have && c_valid[i];
  const i64 ci =
      have ? moved(i, best_pos, m_all, M_all, c_idx, c_valid) : 0;
  const char* b_row = hist + ci * hpitch;
  Piece<VEC> b = {};
  if (nv <= lanes && have && sub < nv) b = load_center<VEC>(b_row + sub * VEC);
  const double mag_b = mag[ci], sq_b = sq[ci], len_b = lenf[ci];
  double best_f1 = kDblMin;
  i64 best_t = i;
  i64 my_man = 0, my_dot = 0, my_a = -1;
  for (int oi = 0; oi < delta; ++oi) {
    const i64 j = i + oi + 1;
    const bool ok = vi && j < C && c_valid[j];
    const i64 cj = ok ? moved(j, best_pos, m_all, M_all, c_idx, c_valid) : 0;
    i64 man, dot;
    pair_sums<T, VEC>(hist + cj * hpitch, b_row, b, ok, nv, sub, lanes, man,
                      dot);
    const int at = oi & (lanes - 1);
    if (sub == at) {
      my_man = man;
      my_dot = dot;
      my_a = ok ? cj : -1;
    }
    if (at != lanes - 1 && oi != delta - 1) continue;
    bool pos = false;
    double f1 = 0.0;
    if (sub <= at && my_a >= 0)
      pos = classify(spec, coef, static_cast<double>(my_man),
                     static_cast<double>(my_dot), mag[my_a], mag_b, sq[my_a],
                     sq_b, lenf[my_a], len_b, &f1);
    for (int l = 0; l < lanes; ++l) {
      const int src = grp * lanes + l;
      const int pl = __shfl_sync(0xffffffffu, static_cast<int>(pos), src);
      const double fl = __shfl_sync(0xffffffffu, f1, src);
      if (l <= at && pl && fl > best_f1) {
        best_f1 = fl;
        best_t = i + (oi - at + l) + 1;
      }
    }
  }
  if (have && sub == 0) {
    t_row[i] = vi ? best_t : i;
    c_new[i] = ci;
  }
  if (!last_block(scr + kTicket, gridDim.x)) return;

  for (int k = tid; k < C; k += kThreads) Tc[k] = __ldcg(t_row + k);
  __syncthreads();
  for (;;) {
    int changed = 0;
    for (int k = tid; k < C; k += kThreads) {
      const i64 a = Tc[k], e = Tc[a];
      if (e != a) {
        Tc[k] = e;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  int kept_total = 0;
  for (int k0 = 0; k0 < C; k0 += kThreads) {
    const int k = k0 + tid;
    const int kept = k < C && c_valid[k] && __ldcg(t_row + k) == k;
    int total;
    const int incl = block_scan(kept, &total);
    if (k < C) NP[k] = kept_total + incl - 1;
    kept_total += total;
  }
  __syncthreads();
  for (int k = tid; k < C; k += kThreads) {
    remap[k] = NP[Tc[k]];
    if (NP[k] != (k ? NP[k - 1] : -1)) c_idx[NP[k]] = __ldcg(c_new + k);
    if (k >= kept_total) c_idx[k] = 0;
    c_valid[k] = k < kept_total;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points: launch on the caller's stream, return cudaGetLastError().
// `width` is the rows' element size in bytes (1, 2, 4 or 8); strides are in
// elements.
// ---------------------------------------------------------------------------

static int tiles(int n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }
static int thread_blocks(int n) {
  return n > 0 ? (n + kThreads - 1) / kThreads : 1;
}

// The classifier's shared memory (ops/phase_a.py:Model keeps it below the
// 48 KB a launch may take without an attribute).
static size_t model_bytes(int n_spec, int n_coef) {
  return n_coef * sizeof(double) + n_spec * sizeof(int);
}

template <typename T, int VEC>
static int launch_band(cudaStream_t s, const void* rows, i64 pitch,
                       const void* hist, i64 hpitch, i64 length, int V,
                       const void* m_idx, const void* m_valid, int M,
                       void* assign, const void* remap, const void* c_idx,
                       const void* c_valid, int C, const void* mag,
                       const void* sq, const void* lenf, const void* spec,
                       int n_spec, const void* coef, int n_coef, int delta,
                       int W, void* bits, void* sc, void* best_d,
                       void* best_pos, long long m_all) {
  pb_band_kernel<T, VEC>
      <<<tiles(M), kThreads, model_bytes(n_spec, n_coef), s>>>(
          static_cast<const char*>(rows), pitch,
          static_cast<const char*>(hist), hpitch,
          static_cast<int>(length / VEC), V, static_cast<const i64*>(m_idx),
          static_cast<const uint8_t*>(m_valid), M, static_cast<i64*>(assign),
          static_cast<const i64*>(remap), static_cast<const i64*>(c_idx),
          static_cast<const uint8_t*>(c_valid), C,
          static_cast<const double*>(mag), static_cast<const double*>(sq),
          static_cast<const double*>(lenf), static_cast<const int*>(spec),
          n_spec, static_cast<const double*>(coef), n_coef, delta, W,
          static_cast<unsigned*>(bits), static_cast<i64*>(sc),
          static_cast<double*>(best_d), static_cast<i64*>(best_pos), m_all);
  return cudaGetLastError();
}

// The widest piece that divides both row arrays' addresses and pitches and
// the rows' length.
static int pair_piece(const void* rows, i64 pitch, const void* hist,
                      i64 hpitch, i64 length, int width) {
  const void* both = reinterpret_cast<const void*>(
      reinterpret_cast<u64>(rows) | reinterpret_cast<u64>(hist));
  return piece_bytes(both, pitch | hpitch, length, width);
}

extern "C" int mc_pb_band(const void* rows, long long stride,
                          const void* hist, long long hstride, int V,
                          int width, const void* m_idx, const void* m_valid,
                          int M, void* assign, const void* remap,
                          const void* c_idx, const void* c_valid, int C,
                          const void* mag, const void* sq, const void* lenf,
                          const void* spec, int n_spec, const void* coef,
                          int n_coef, int delta, void* bits, void* sc,
                          void* best_d, void* best_pos, long long m_all,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 pitch = stride * width, hpitch = hstride * width;
  const i64 length = static_cast<i64>(V) * width;
  const int vec = pair_piece(rows, pitch, hist, hpitch, length, width);
  const int W = (2 * delta + 1 + 31) / 32;
#define MC_BAND(T, VEC)                                                     \
  case VEC:                                                                 \
    return launch_band<T, VEC>(s, rows, pitch, hist, hpitch, length, V,     \
                               m_idx, m_valid, M, assign, remap, c_idx,     \
                               c_valid, C, mag, sq, lenf, spec, n_spec,     \
                               coef, n_coef, delta, W, bits, sc, best_d,    \
                               best_pos, m_all)
  MC_ROW_CASES(MC_BAND);
#undef MC_BAND
}

template <typename T, int VEC>
static int launch_dist(cudaStream_t s, const void* rows, i64 pitch, int V,
                       const void* m_idx, int M, const void* assign,
                       const void* mag, int delta, const void* bits,
                       const void* sc, void* dstore, void* best_d) {
  pb_dist_kernel<T, VEC><<<thread_blocks(M), kThreads, 0, s>>>(
      static_cast<const char*>(rows), pitch, V,
      static_cast<const i64*>(m_idx), M, static_cast<const i64*>(assign),
      static_cast<const double*>(mag), delta, (2 * delta + 1 + 31) / 32,
      static_cast<const unsigned*>(bits), static_cast<const i64*>(sc),
      static_cast<double*>(dstore), static_cast<double*>(best_d));
  return cudaGetLastError();
}

extern "C" int mc_pb_dist(const void* rows, long long stride, int V,
                          int width, const void* m_idx, int M,
                          const void* assign, const void* mag, int delta,
                          const void* bits, const void* sc, void* dstore,
                          void* best_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 pitch = stride * width, length = static_cast<i64>(V) * width;
  const int vec = piece_bytes(rows, pitch, length, width);
#define MC_DIST(T, VEC)                                                    \
  case VEC:                                                                \
    return launch_dist<T, VEC>(s, rows, pitch, V, m_idx, M, assign, mag,   \
                               delta, bits, sc, dstore, best_d)
  MC_ROW_CASES(MC_DIST);
#undef MC_DIST
}

extern "C" int mc_pb_pick(int M, const void* assign, int delta,
                          const void* bits, const void* dstore,
                          const void* best_d, void* best_pos, long long goff,
                          void* sc, long long sc_len, void* stream) {
  pb_pick_kernel<<<thread_blocks(M), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      M, static_cast<const i64*>(assign), delta, (2 * delta + 1 + 31) / 32,
      static_cast<const unsigned*>(bits), static_cast<const double*>(dstore),
      static_cast<const double*>(best_d), static_cast<i64*>(best_pos), goff,
      static_cast<i64*>(sc), sc_len);
  return cudaGetLastError();
}

template <typename T, int VEC>
static int launch_merge(cudaStream_t s, const void* hist, i64 hpitch,
                        i64 length, int C, void* c_idx, void* c_valid,
                        const void* best_pos, const void* m_all,
                        long long M_all, const void* mag, const void* sq,
                        const void* lenf, const void* spec, int n_spec,
                        const void* coef, int n_coef, int delta, void* t_row,
                        void* remap, void* scratch) {
  const int nv = static_cast<int>(length / VEC);
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  const int per_block = kWarps * (32 / lanes);
  pb_merge_kernel<T, VEC><<<(C + per_block - 1) / per_block, kThreads,
                            model_bytes(n_spec, n_coef), s>>>(
      static_cast<const char*>(hist), hpitch, nv, C, static_cast<i64*>(c_idx),
      static_cast<uint8_t*>(c_valid), static_cast<const i64*>(best_pos),
      static_cast<const i64*>(m_all), M_all, static_cast<const double*>(mag),
      static_cast<const double*>(sq), static_cast<const double*>(lenf),
      static_cast<const int*>(spec), n_spec,
      static_cast<const double*>(coef), n_coef, delta,
      static_cast<i64*>(t_row), static_cast<i64*>(remap),
      static_cast<i64*>(scratch));
  return cudaGetLastError();
}

extern "C" int mc_pb_merge(const void* hist, long long hstride, int V,
                           int width, int C, void* c_idx, void* c_valid,
                           const void* best_pos, const void* m_all,
                           long long M_all, const void* mag, const void* sq,
                           const void* lenf, const void* spec, int n_spec,
                           const void* coef, int n_coef, int delta,
                           void* t_row, void* remap, void* scratch,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 hpitch = hstride * width, length = static_cast<i64>(V) * width;
  const int vec = piece_bytes(hist, hpitch, length, width);
#define MC_MERGE(T, VEC)                                                     \
  case VEC:                                                                  \
    return launch_merge<T, VEC>(s, hist, hpitch, length, C, c_idx, c_valid, \
                                best_pos, m_all, M_all, mag, sq, lenf, spec, \
                                n_spec, coef, n_coef, delta, t_row, remap,   \
                                scratch)
  MC_ROW_CASES(MC_MERGE);
#undef MC_MERGE
}
#undef MC_ROW_CASES
