// Phase A's absorb iteration for Hopper (sm_90a): five kernels over the live
// window, with the slot state and the loop's control on the device.
//
// Replaces, as XLA and not Pallas, the absorb iteration of
// meshclust_tpu/core/accumulate_device.py:87 build_accumulate: its
// window_bounds (:173), classify_full (:237) and mean_argmin_full (:394),
// which the JAX package runs inside one lax.while_loop. An iteration is a
// fixed chain of five launches, with no host decision in it
// (core/accumulate_device.py captures CHUNK iterations in a CUDA graph and
// replays it until st[kDone] is set):
//   pa_window       the live window [w0, w1] of the center (bvec::get_range,
//                   every case of bvec::inner_index_of) and the first and
//                   last live slots, as firsts and lasts of live flags in
//                   slot ranges that the center's row of a table names;
//   pa_sums         man = sum |a - b| and dot = sum a * b of the center's row
//                   against each live row of the window (Scorer.sums), int64;
//   pa_absorb       the float64 classifier on each live slot of the window
//                   (Scorer.__call__), the absorb of the positives into the
//                   center st[kC] at stamp st[kT] (owner, stamp, active,
//                   n_pos, their rows added into sumvec) and the first max of
//                   f1 (the next seed);
//   pa_move         if the iteration absorbed: mean_argmin_full (:394): cw =
//                   floor(sumvec / count), 2 * sum min(h, cw) of each
//                   member's row (owner == c) and sum cw, and the member
//                   closest to the mean by distance_d, ties to the least
//                   stamp, then the least slot: the new center;
//   pa_next         the host loop's decisions: if nothing was absorbed, the
//                   center's slot recorded and the next center seeded (the
//                   window's best candidate, else the first live slot), or
//                   the phase done; the stamp and iteration counters.
// Every one of them returns at once when st[kDone] is set, so iterations
// past the phase's end change nothing.
//
// State: st, one int64 buffer (ops/phase_a.py names its slots): n_pos, best,
// center slot, first live slot, w0, w1, the member count, the last live
// slot, pa_absorb's ticket, pa_move's counter, an unused slot, then the
// loop's: the done flag, the iterations, the current center's id (the
// number of centers recorded before it), the members of the recorded
// centers (the host reads these four back once a replay) and the stamp of
// the next absorb. Every reduction is exact and independent of the order
// in which blocks run: integer atomicAdd, or per-block partials that
// the last block to finish (the one that draws the last ticket, or whose
// members complete the count) combines under explicit tie rules. So every
// result is bit-equal to the plain version's. No float is ever summed. Every
// float64 operation of the classifier and of the mean is an explicit
// round-to-nearest intrinsic in the plain version's order: nvcc contracts
// a * b + c into an FMA by default (--fmad=true), and the decisions would
// drift from the host classifier's.
//
// Bound: bytes, each kernel's (chip_smoke.py:phase_a_traffic counts them
// from a run's data):
//   pa_window       the center's row of the table (32 B), and the flags
//                   (1 B) of each range it must decide, up to the live slot
//                   that decides it;
//   pa_sums         the window's live rows (V x the storage width each) and
//                   the center's, their sums written (8 B each);
//   pa_absorb       the live window slots' sums, mag, sq and len (32-40 B),
//                   the positives' rows and owner, stamp and active writes;
//   pa_move         owner of every slot (8 B), the members' rows, sumvec,
//                   mag and stamp (8 B each) of the members, their dist
//                   written (8 B);
//   pa_next         st, and where a center begins, its seed's row (V x the
//                   storage width), sumvec written and four slot writes.
// So an iteration must read the window's live rows once in their storage
// dtype (V bytes a row at the k-mer path's int8 counts) plus O(N) slot
// arrays. At 150k reads of ~1 kb the window holds up to all the live rows,
// 150k x 256 B = 38 MB: 11.5 us at 3.35 TB/s. The design reads only the
// window's rows (slots are sorted by length, so a window is one slot
// range), each once in its storage dtype, widened in registers (no widened
// [N, V] copy); keeps the classifier in registers; reads member rows only
// where owner == c; and runs grids that walk any range, so a window of any
// size is one launch with no host decision.
//
// pa_sums carries the bytes: at 1M reads a window holds up to 256 MB of
// int8 rows, past the 50 MB L2. A warp a row with one int8 a lane kept
// ~64 B in flight a warp, so Little's law held it near 0.3 TB/s. Here each
// lane loads 16-byte pieces (a row of 256 int8 is 16 lanes, two rows a warp
// load), kUnroll loads in flight before it reduces (2 KB a warp, ~10 MB
// over the resident grid), the center's piece in a register, |a - b| and
// a * b four bytes at a time (__vsadu4, __dp4a) into 32-bit partials.
// pa_absorb's bound is a few us; its cost was fixed: every block staged the
// model and ran its reductions whatever the window, and norm[] was indexed
// at run time. Here blocks with no slot return at once (only the busy ones
// draw tickets and write partials), the model's loads go out beside the
// state's, the classifier is unrolled over kMaxSingles (no local memory),
// one block reduction takes f1 and n_pos together, and a tile's positives'
// rows are summed in registers, one atomic a count a tile.
// pa_window's bound is well under a microsecond: its time is the latency
// of a chain of loads. Over all N slots' flags with 528 blocks, eight
// int64 block reductions and eight global atomics each, it took 7-15 us.
// Here one block reads the center's table row and then only the flags of
// the ranges it decides, a warp a range, all at once (pa_window_kernel).
// The move served each member with one warp, one count a lane, and divided
// the mean again for every member and lane: a center's members sit in
// neighbouring slots, so a few warps ran them one after another. Here a
// block divides the mean once into shared memory, compacts its members and
// serves them as pa_sums serves rows: lane groups over 16-byte pieces,
// byte SIMD for int8, several members in flight. Its argmin scanned all N
// owners again, over a fixed grid of 528 blocks, each writing three
// partials and drawing a ticket: at 1M slots a move read the 8 MB of
// owners twice, in two launches, each with its own host cost. pa_move
// never finds the members twice: the blocks of its tiles that hold a
// member reduce the argmin of their own list, and the blocks with none
// (most of ~977 at 1M) return after the owners' scan, with no ticket; the
// block whose members complete st[kCount] combines the few partials.
// With the iteration's kernels at ~0.02 ms, the host loop that read four
// scalars back an iteration and chose the next launch from them cost ten
// times that in Python, ctypes and the sync, with the card idle. pa_next
// makes those choices on the card, so an iteration is a fixed chain of
// launches whose arguments never change: the host replays it as a CUDA
// graph, CHUNK iterations a replay, and reads back once a replay. Every
// kernel's first read is st[kDone], so a replay's iterations past the
// phase's end cost a launch each and change nothing.
#include "common.cuh"

namespace {

// The most blocks pa_absorb's grid may take (4 an SM), and the partials a
// block writes there. The partials' buffer `part` holds kPartials x
// max(kBlocks, tiles) int64 (pa_move writes three a busy tile).
constexpr int kBlocks = 528;
constexpr int kPartials = 4;
// pa_window: its one block's warps (a query each), and the 16-byte vectors
// of flags a lane has in flight a step.
constexpr int kWindowWarps = 7;
constexpr int kWinLoads = 2;
// pa_move: the 16-byte loads of owners (two slots each) a thread makes (a
// block's tile: kThreads * 2 * kOwnerLoads slots).
constexpr int kOwnerLoads = 2;
constexpr int kTileSlots = kThreads * 2 * kOwnerLoads;

// Slots of st (ops/phase_a.py: NPOS ... MOVE): pa_absorb's ticket; pa_move's
// partials drawn and members counted (one counter: pa_move_kernel). Slot 10
// is unused.
constexpr int kNPos = 0, kBest = 1, kLast = 2, kLive = 3, kW0 = 4, kW1 = 5,
              kCount = 6, kTail = 7;
constexpr int kTicket = 8, kMove = 9;
// The loop's slots (ops/phase_a.py: DONE ... T): pa_next's alone, but for
// kC and kT, which pa_absorb and pa_move read.
constexpr int kDone = 11, kIters = 12, kC = 13, kMembers = 14, kT = 15;
// Columns of pa_window's table, a row a slot (ops/phase_a.py: RANGES).
constexpr int kRanges = 8;
constexpr int kFront = 0, kGe = 1, kFrontEnd = 2, kBack = 3, kEq = 4,
              kGt = 5, kBackEnd = 6, kBin = 7;

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

__device__ __forceinline__ DBest shfl(DBest v, int o) {
  return {__shfl_xor_sync(0xffffffffu, v.d, o),
          __shfl_xor_sync(0xffffffffu, v.stamp, o),
          __shfl_xor_sync(0xffffffffu, v.s, o)};
}

// ---------------------------------------------------------------------------
// pa_window
// ---------------------------------------------------------------------------

// Bit i set where slot s0 + i (0 <= i < 16) is live and lies in [a, b). s0
// is the first slot of a 16-byte-aligned vector of flags: one 16-byte load
// where all 16 lie in [0, n), else byte loads of those that do; none where
// the vector misses [a, b). A word's nonzero bytes become 4 bits: 0xff per
// nonzero byte (__vcmpne4), one distinct bit a byte (& 0x08040201), summed
// into the top byte by the multiply (no carries: the sum is at most 15).
__device__ __forceinline__ unsigned live_bits(const uint8_t* act, i64 n,
                                              i64 s0, i64 a, i64 b) {
  if (s0 >= b || s0 + 16 <= a) return 0u;
  uint32_t w[4];
  if (s0 >= 0 && s0 + 16 <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(act + s0));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const i64 s = s0 + 4 * k + e;
        if (s >= 0 && s < n) w[k] |= static_cast<uint32_t>(act[s]) << (8 * e);
      }
    }
  }
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    bits |= ((__vcmpne4(w[k], 0u) & 0x08040201u) * 0x01010101u) >> 24
            << (4 * k);
  const i64 lo = a - s0, hi = b - s0;
  if (lo > 0) bits &= 0xffffu << lo;
  if (hi < 16) bits &= (1u << hi) - 1u;
  return bits;
}

// The first slot of a 16-byte-aligned vector of flags at or before slot s
// (mis: the flags' address mod 16).
__device__ __forceinline__ i64 vector_of(i64 s, int mis) {
  return s - ((s + mis) & 15);
}

// The first live slot of [a, b), -1 if none: the warp reads kWinLoads
// vectors a lane, 32 * kWinLoads vectors a step in slot order, and stops at
// the first step that holds a live flag (ballot, then __ffs of the first
// lane's bits).
__device__ i64 first_live(const uint8_t* act, i64 n, int mis, i64 a, i64 b) {
  const int lane = threadIdx.x & 31;
  if (a >= b) return -1;
  for (i64 base = vector_of(a, mis); base < b;
       base += 16 * 32 * kWinLoads) {
    unsigned bits[kWinLoads];
#pragma unroll
    for (int u = 0; u < kWinLoads; ++u)
      bits[u] = live_bits(act, n, base + 16 * (u * 32 + lane), a, b);
#pragma unroll
    for (int u = 0; u < kWinLoads; ++u) {
      const unsigned hit = __ballot_sync(0xffffffffu, bits[u] != 0u);
      if (hit) {
        const int l = __ffs(hit) - 1;
        const unsigned m = __shfl_sync(0xffffffffu, bits[u], l);
        return base + 16 * (u * 32 + l) + __ffs(m) - 1;
      }
    }
  }
  return -1;
}

// The last live slot of [a, b), -1 if none: the same steps downwards from
// the vector that holds slot b - 1 (lane 0 the highest vector; the first
// lane with a hit, then 31 - __clz of its bits).
__device__ i64 last_live(const uint8_t* act, i64 n, int mis, i64 a, i64 b) {
  const int lane = threadIdx.x & 31;
  if (a >= b) return -1;
  for (i64 top = vector_of(b - 1, mis); top + 16 > a;
       top -= 16 * 32 * kWinLoads) {
    unsigned bits[kWinLoads];
#pragma unroll
    for (int u = 0; u < kWinLoads; ++u)
      bits[u] = live_bits(act, n, top - 16 * (u * 32 + lane), a, b);
#pragma unroll
    for (int u = 0; u < kWinLoads; ++u) {
      const unsigned hit = __ballot_sync(0xffffffffu, bits[u] != 0u);
      if (hit) {
        const int l = __ffs(hit) - 1;
        const unsigned m = __shfl_sync(0xffffffffu, bits[u], l);
        return top - 16 * (u * 32 + l) + 31 - __clz(m);
      }
    }
  }
  return -1;
}

// Inclusive slot range [w0, w1] of get_range(lo, hi) of the center at slot
// st[kLast] over the live slots. Slots are in bvec order (bins concatenated,
// lengths non-decreasing), so every case is a first or last live slot of a
// slot range that depends on the center alone: its row of the table
// `ranges` (core/accumulate_device.py:window_ranges, built once a phase).
// One block, a warp a query, all seven at once:
//   warp 0  the first live slot, on from st[kLive]; warp 1 the last, down
//           from st[kTail] (slots only die in a phase, so both move one way
//           and their scans add up to N a phase);
//   warp 2  A: first live of [kGe, kFrontEnd) (front bin, length >= lo);
//   warp 3  B: last live of [kFront, kGe);
//   warp 4  C: last live of [kEq, kGt) (back bin, length == hi);
//   warp 5  D: first live of [kGt, kBackEnd) (length > hi);
//   warp 6  E: last live of [kBack, kEq).
// w0 = A, else B (the front bin's last live slot), else the first live
// slot; w1 = C, else D, else E (the back bin's last live slot); a back bin
// with no live slot gives the FIRST live slot of the LAST non-empty bin
// (the truncation quirk): warp 0 scans [kBin of the last live slot, it],
// or -1 if nothing is live. Every range but the two scans' is one bin
// (1,000 slots at the default bin size: one or two steps of a warp), so
// one block does it all, with no ticket, scratch or atomic.
__global__ void __launch_bounds__(kWindowWarps * 32)
pa_window_kernel(i64* __restrict__ st, const uint8_t* __restrict__ active,
                 const int* __restrict__ ranges, int n) {
  __shared__ i64 found[kWindowWarps];
  if (st[kDone]) return;
  const int warp = threadIdx.x >> 5;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(active) & 15);
  const i64 N = n;
  i64 r;
  if (warp == 0) {
    r = first_live(active, N, mis, st[kLive], N);
  } else if (warp == 1) {
    r = last_live(active, N, mis, 0, st[kTail] + 1);
  } else {
    const int* row = ranges + kRanges * st[kLast];
    const int q = warp - 2;
    const int from = q == 0 ? kGe : q == 1 ? kFront : q == 2 ? kEq
                   : q == 3 ? kGt : kBack;
    const int to = q == 0 ? kFrontEnd : q == 1 ? kGe : q == 2 ? kGt
                 : q == 3 ? kBackEnd : kEq;
    const i64 a = __ldg(row + from), b = __ldg(row + to);
    r = q == 0 || q == 3 ? first_live(active, N, mis, a, b)
                         : last_live(active, N, mis, a, b);
  }
  if ((threadIdx.x & 31) == 0) found[warp] = r;
  __syncthreads();
  if (warp != 0) return;
  const i64 first = found[0] < 0 ? N : found[0], tail = found[1];
  const i64 w0 = found[2] >= 0 ? found[2] : found[3] >= 0 ? found[3] : first;
  i64 w1 = found[4] >= 0 ? found[4] : found[5] >= 0 ? found[5] : found[6];
  if (w1 < 0 && tail >= 0)
    w1 = first_live(active, N, mis, __ldg(ranges + kRanges * tail + kBin),
                    tail + 1);
  if (threadIdx.x == 0) {
    st[kW0] = w0;
    st[kW1] = w1;
    st[kLive] = first;
    st[kTail] = tail;
  }
}

// ---------------------------------------------------------------------------
// pa_sums
// ---------------------------------------------------------------------------

// sums[s] = man, sums[n + s] = dot (with_dot) of every live slot s of
// [w0, w1]. A row is nv pieces of VEC bytes. Short rows (nv <= lanes, the
// k-mer path's 256 int8 counts: 16 pieces of 16 B): a group of `lanes`
// lanes a row, 32 / lanes rows a warp load, kUnroll loads in flight before
// any reduction (8 rows, 2 KB a warp at V = 256), the center's piece in a
// register. Long rows: a warp a row, each lane kUnroll pieces in flight.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pa_sums_kernel(const i64* __restrict__ st, const uint8_t* __restrict__ active,
               const char* __restrict__ rows, i64 pitch, int nv, int lanes,
               int n, int with_dot, i64* __restrict__ sums) {
  typedef typename Acc<T>::type A;
  if (st[kDone]) return;
  const i64 w0 = st[kW0], w1 = st[kW1];
  const char* a_row = rows + st[kLast] * pitch;
  const int lane = threadIdx.x & 31;
  const i64 warp = blockIdx.x * static_cast<i64>(kWarps) + (threadIdx.x >> 5);
  const i64 warps = static_cast<i64>(gridDim.x) * kWarps;
  if (nv <= lanes) {
    const int sub = lane & (lanes - 1), grp = lane / lanes;
    const int groups = 32 / lanes;
    const Piece<VEC> a =
        sub < nv ? load_center<VEC>(a_row + sub * VEC) : Piece<VEC>{};
    const i64 step = static_cast<i64>(groups) * kUnroll;
    for (i64 s0 = w0 + warp * step; s0 <= w1; s0 += warps * step) {
      Piece<VEC> b[kUnroll];
      bool live[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const i64 s = s0 + u * groups + grp;
        live[u] = s <= w1 && active[s];
        b[u] = Piece<VEC>{};
        if (live[u] && sub < nv)
          b[u] = load_row<VEC>(rows + s * pitch + sub * VEC);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        A man = 0, dot = 0;
        add_piece<T, VEC>(a, b[u], man, dot);
        man = group_sum(man, lanes);
        if (with_dot) dot = group_sum(dot, lanes);
        if (live[u] && sub == 0) {
          const i64 s = s0 + u * groups + grp;
          sums[s] = man;
          if (with_dot) sums[n + s] = dot;
        }
      }
    }
    return;
  }
  for (i64 s = w0 + warp; s <= w1; s += warps) {
    if (!active[s]) continue;
    const char* b_row = rows + s * pitch;
    i64 man = 0, dot = 0;
    for (int v0 = lane; v0 < nv; v0 += 32 * kUnroll) {
      Piece<VEC> a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        a[u] = b[u] = Piece<VEC>{};
        if (v < nv) {
          a[u] = load_center<VEC>(a_row + static_cast<i64>(v) * VEC);
          b[u] = load_row<VEC>(b_row + static_cast<i64>(v) * VEC);
        }
      }
      A m = 0, d = 0;                  // kUnroll pieces: within 32 bits
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_piece<T, VEC>(a[u], b[u], m, d);
      man += m;
      dot += d;
    }
    man = group_sum(man, 32);
    if (with_dot) dot = group_sum(dot, 32);
    if (lane == 0) {
      sums[s] = man;
      if (with_dot) sums[n + s] = dot;
    }
  }
}

// ---------------------------------------------------------------------------
// pa_absorb
// ---------------------------------------------------------------------------

// A block's partial of pa_absorb: the first max of f1 (the greater f1, the
// least slot among equal f1; a NaN anywhere makes the result N, as torch's
// max propagates NaN) and the positives' count.
struct AbsorbPart {
  double f;
  i64 s;
  i64 npos;
  int nan;
};
struct AbsorbOp {
  __device__ AbsorbPart operator()(AbsorbPart a, AbsorbPart b) const {
    AbsorbPart r = (b.f > a.f || (b.f == a.f && b.s < a.s)) ? b : a;
    r.nan = a.nan | b.nan;
    r.npos = a.npos + b.npos;
    return r;
  }
};
__device__ __forceinline__ AbsorbPart shfl(AbsorbPart v, int o) {
  return {__shfl_xor_sync(0xffffffffu, v.f, o),
          __shfl_xor_sync(0xffffffffu, v.s, o),
          __shfl_xor_sync(0xffffffffu, v.npos, o),
          __shfl_xor_sync(0xffffffffu, v.nan, o)};
}

// A thread a live slot of [w0, w1], in block-wide tiles, absorbed into the
// center st[kC] at stamp st[kT]. The blocks that
// hold a slot of [w0, w1] (the first `busy`, known to every block from w0
// and w1) do the work; the others return after reading them, and when no
// block holds a slot, block 0 writes the empty window's result. A busy
// block stages the model in shared memory (its loads issued beside the
// state's), loads each slot's sums, mag, sq and length at once,
// classifies, absorbs, and lists the tile's positives; its threads then
// sum the listed rows count by count in registers and add each count into
// sumvec with one int64 atomic a tile. Per-block partials (part: f1 bits,
// slot, NaN, n_pos; busy <= gridDim.x <= kBlocks each) are combined by the
// last busy block to draw a ticket.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pa_absorb_kernel(i64* __restrict__ st, const i64* __restrict__ sums,
                 int with_dot, const int* __restrict__ spec_g, int n_spec,
                 const double* __restrict__ coef_g, int n_coef,
                 const double* __restrict__ mag, const double* __restrict__ sq,
                 const double* __restrict__ lenf, i64* __restrict__ owner,
                 i64* __restrict__ stamp, uint8_t* __restrict__ active,
                 const T* __restrict__ rows, i64 stride, int V,
                 i64* __restrict__ sumvec, int n, i64* __restrict__ part) {
  extern __shared__ double model[];
  __shared__ i64 pos_list[kThreads];
  __shared__ int n_list;
  if (st[kDone]) return;
  const int tid = threadIdx.x;
  const double coef0 = tid < n_coef ? coef_g[tid] : 0.0;
  const int spec0 = tid < n_spec ? spec_g[tid] : 0;
  const i64 N = n, w0 = st[kW0], w1 = st[kW1];
  const i64 tiles = static_cast<i64>(gridDim.x) * kThreads;
  const i64 span = w1 - w0 + 1;
  const i64 busy = span <= 0 ? 0 : imin((span + kThreads - 1) / kThreads,
                                        static_cast<i64>(gridDim.x));
  if (blockIdx.x >= busy) {
    if (busy == 0 && blockIdx.x == 0 && tid == 0) {
      st[kNPos] = 0;
      st[kBest] = N;
    }
    return;
  }
  AbsorbPart best = {-INFINITY, N, 0, 0};
  double* coef = model;
  int* spec = reinterpret_cast<int*>(model + n_coef);
  if (tid < n_coef) coef[tid] = coef0;
  if (tid < n_spec) spec[tid] = spec0;
  for (int i = tid + kThreads; i < n_coef; i += kThreads) coef[i] = coef_g[i];
  for (int i = tid + kThreads; i < n_spec; i += kThreads) spec[i] = spec_g[i];
  const i64 last = st[kLast], c = st[kC], t = st[kT];
  const double mag_a = mag[last], sq_a = sq[last], len_a = lenf[last];
  for (i64 base = w0 + blockIdx.x * static_cast<i64>(kThreads); base <= w1;
       base += tiles) {
    const i64 s = base + tid;
    bool live = false;
    i64 man = 0, dot = 0;
    double mag_b = 0.0, sq_b = 0.0, len_b = 0.0;
    if (s <= w1) {
      live = active[s];
      man = sums[s];
      if (with_dot) dot = sums[N + s];
      mag_b = mag[s];
      sq_b = sq[s];
      len_b = lenf[s];
    }
    if (tid == 0) n_list = 0;
    __syncthreads();              // also: the model is in shared memory
    if (live) {
      double f1;
      const bool pos = classify(spec, coef, static_cast<double>(man),
                                static_cast<double>(dot), mag_a, mag_b,
                                sq_a, sq_b, len_a, len_b, &f1);
      if (f1 != f1)
        best.nan = 1;
      else if (f1 > best.f || (f1 == best.f && s < best.s))
        best.f = f1, best.s = s;
      if (pos) {
        owner[s] = c;
        stamp[s] = t;
        active[s] = 0;
        ++best.npos;
        pos_list[atomicAdd(&n_list, 1)] = s;
      }
    }
    __syncthreads();
    const int m = n_list;
    if (m) {
      for (int v = tid; v < V; v += kThreads) {
        i64 acc = 0;
        for (int i = 0; i < m; ++i) acc += rows[pos_list[i] * stride + v];
        atomicAdd(reinterpret_cast<u64*>(sumvec + v),
                  static_cast<u64>(acc));
      }
    }
    __syncthreads();              // before the next tile resets n_list
  }
  best = block_reduce(best, AbsorbOp());
  const int G = gridDim.x;
  if (tid == 0) {
    part[blockIdx.x] = __double_as_longlong(best.f);
    part[G + blockIdx.x] = best.s;
    part[2 * G + blockIdx.x] = best.nan;
    part[3 * G + blockIdx.x] = best.npos;
  }
  if (!last_block(st + kTicket, busy)) return;
  best = {-INFINITY, N, 0, 0};
  for (int b = tid; b < busy; b += kThreads)
    best = AbsorbOp()(best, {__longlong_as_double(__ldcg(part + b)),
                             __ldcg(part + G + b), __ldcg(part + 3 * G + b),
                             static_cast<int>(__ldcg(part + 2 * G + b))});
  best = block_reduce(best, AbsorbOp());
  if (tid == 0) {
    st[kNPos] = best.npos;
    st[kBest] = best.nan ? N : best.s;
    st[kCount] += best.npos;
  }
}

// ---------------------------------------------------------------------------
// pa_move
// ---------------------------------------------------------------------------

// The members (owner == c) of a block's tile of kTileSlots slots, compacted
// into list in shared memory; -> their number, in every thread. Each thread
// reads kOwnerLoads 16-byte vectors of owner (two slots each; single loads
// where owner is not 16-byte aligned or at the end), and a warp appends a
// load's members with a ballot and one shared atomic.
__device__ int tile_members(const i64* __restrict__ owner, i64 c, int n,
                            int* list, int* n_list) {
  const int tid = threadIdx.x, lane = tid & 31;
  const i64 tile = blockIdx.x * static_cast<i64>(kTileSlots);
  const bool vec = (reinterpret_cast<uintptr_t>(owner) & 15) == 0;
  i64 own[2 * kOwnerLoads];
#pragma unroll
  for (int j = 0; j < kOwnerLoads; ++j) {
    const i64 s = tile + 2 * (j * kThreads + tid);
    if (vec && s + 2 <= n) {
      const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(owner + s));
      own[2 * j] = v.x, own[2 * j + 1] = v.y;
    } else {
      own[2 * j] = s < n ? owner[s] : -1;
      own[2 * j + 1] = s + 1 < n ? owner[s + 1] : -1;
    }
  }
  if (tid == 0) *n_list = 0;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 2 * kOwnerLoads; ++e) {
    const i64 s = tile + 2 * ((e >> 1) * kThreads + tid) + (e & 1);
    const bool is = s < n && own[e] == c;
    const unsigned b = __ballot_sync(0xffffffffu, is);
    if (b) {
      int at = 0;
      if (lane == 0) at = atomicAdd(n_list, __popc(b));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (is) list[at + __popc(b & ((1u << lane) - 1u))] = static_cast<int>(s);
    }
  }
  __syncthreads();
  return *n_list;
}

// distance_d of member s to the mean: frac = dist / (mag + cw_sum), d =
// 10000 * (1 - frac * frac), each operation rounded as the plain version's
// (no FMA), with its tie keys.
__device__ __forceinline__ DBest member_d(i64 s, i64 dist_s, double mag_s,
                                          i64 stamp_s, double cw_sum) {
  const double frac =
      __ddiv_rn(static_cast<double>(dist_s), __dadd_rn(mag_s, cw_sum));
  return {__dmul_rn(10000.0, __dsub_rn(1.0, __dmul_rn(frac, frac))), stamp_s,
          s};
}

// The move, one launch, of the center c = st[kC] in an iteration that
// absorbed (it returns at once where st[kNPos] is 0, or st[kDone] set): a
// block a tile of owners (tile_members), and in each busy block the
// distances of its members to the floored mean (tile_dist) and their
// argmin. A block with no member returns after the owners' scan (no
// atomic, no partial). A busy block draws its partial's index at once (the
// high field of st[kMove]), loads its members' mag and stamp (one a
// thread) beside the mean's division, divides the whole mean (so it has
// sum cw), serves its members, then takes d for each from the distances in
// shared memory and reduces the least (d, stamp, slot) to a partial; after
// a fence it adds its member count to the low field of st[kMove].
// st[kCount] is exactly the number of slots with owner == c (1 at the
// center's start, + n_pos at each absorb), so the one block whose add
// reaches it comes after every other block's add and has every partial, and
// the high field it read back is their number: its first warp combines
// them, writes st[kLast] and dist[n] = sum cw, and resets st[kMove].
constexpr int kMoveShift = 40;
constexpr u64 kMoveMembers = (1ull << kMoveShift) - 1;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pa_move_kernel(i64* __restrict__ st, const i64* __restrict__ owner,
               const char* __restrict__ rows, i64 pitch, int V,
               const i64* __restrict__ sumvec, int n,
               const double* __restrict__ mag, const i64* __restrict__ stamp,
               i64* __restrict__ dist, i64* __restrict__ part) {
  __shared__ __align__(16) char cw_s[kCwBytes];
  __shared__ int list[kTileSlots];
  __shared__ i64 dl[kTileSlots];
  __shared__ int n_list;
  __shared__ i64 wsum[kWarps];
  __shared__ DBest wbest[kWarps];
  if (st[kDone] || st[kNPos] == 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const i64 members = st[kCount];
  const double count = static_cast<double>(members);
  const i64 sv0 = tid < V ? sumvec[tid] : 0;
  const int m = tile_members(owner, st[kC], n, list, &n_list);
  if (m == 0) return;
  u64 at = 0;
  if (tid == 0)
    at = atomicAdd(reinterpret_cast<u64*>(st + kMove), 1ull << kMoveShift) >>
         kMoveShift;
  double mag0 = 0.0;
  i64 stamp0 = 0;
  if (tid < m) {
    mag0 = __ldg(mag + list[tid]);
    stamp0 = __ldg(stamp + list[tid]);
  }
  i64 cw_sum = tile_dist<T, VEC>(rows, pitch, V, sumvec, sv0, count, list, m,
                                 cw_s, dl, dist);
  cw_sum = warp_reduce(cw_sum, Sum());
  if (lane == 0) wsum[warp] = cw_sum;
  __syncthreads();                    // also: every member's dl is written
  cw_sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cw_sum += wsum[w];
  const double cw = static_cast<double>(cw_sum);
  const DBest none = {INFINITY, 0x7fffffffffffffffLL, n};
  DBest best = none;
  if (tid < m)
    best = DOp()(best, member_d(list[tid], dl[tid], mag0, stamp0, cw));
  for (int i = tid + kThreads; i < m; i += kThreads) {
    const i64 s = list[i];
    best = DOp()(best, member_d(s, dl[i], __ldg(mag + s), __ldg(stamp + s),
                                cw));
  }
  best = warp_reduce(best, DOp());
  if (lane == 0) wbest[warp] = best;
  __syncthreads();
  if (warp != 0) return;
  best = warp_reduce(lane < kWarps ? wbest[lane] : none, DOp());
  const int G = gridDim.x;
  u64 old = 0;
  if (lane == 0) {
    part[at] = __double_as_longlong(best.d);
    part[G + at] = best.stamp;
    part[2 * G + at] = best.s;
    __threadfence();
    old = atomicAdd(reinterpret_cast<u64*>(st + kMove), static_cast<u64>(m));
  }
  old = __shfl_sync(0xffffffffu, old, 0);
  if ((old & kMoveMembers) + m != static_cast<u64>(members)) return;
  const i64 busy = static_cast<i64>(old >> kMoveShift);
  best = none;
  for (i64 b = lane; b < busy; b += 32)
    best = DOp()(best, {__longlong_as_double(__ldcg(part + b)),
                        __ldcg(part + G + b), __ldcg(part + 2 * G + b)});
  best = warp_reduce(best, DOp());
  if (lane == 0) {
    st[kLast] = best.s;
    dist[n] = cw_sum;
    st[kMove] = 0;
  }
}

// ---------------------------------------------------------------------------
// pa_next
// ---------------------------------------------------------------------------

// The end of an iteration, one block: what the host loop decided from its
// readback. Every thread reads st; then thread 0 writes it. The absorb's
// stamp is spent (st[kT] + 1) and the iteration counted. An iteration that
// absorbed goes on with the same center. One that absorbed nothing ends the
// center: its slot st[kLast] is recorded at center_slot[c], its members are
// added to st[kMembers], and c + 1 is seeded from the window's best
// candidate (st[kBest], erased from the live slots), else the first live
// slot (st[kLive], taken before the absorb, which absorbed nothing). With
// no seed, or c + 1 = cmax centers, the phase is done; else the seed is the
// new center's one member at the next stamp and its row, widened, is
// sumvec, which every thread writes a count at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pa_next_kernel(i64* __restrict__ st, uint8_t* __restrict__ active,
               i64* __restrict__ owner, i64* __restrict__ stamp,
               const T* __restrict__ rows, i64 stride, int V,
               i64* __restrict__ sumvec, i64* __restrict__ center_slot,
               int n, i64 cmax) {
  if (st[kDone]) return;
  const i64 N = n, c = st[kC], t = st[kT] + 1, best = st[kBest];
  const bool ends = st[kNPos] == 0;
  const i64 seed = best < N ? best : st[kLive];
  const bool stop = ends && (seed >= N || c + 1 >= cmax);
  const bool begins = ends && !stop;
  if (begins)
    for (int v = threadIdx.x; v < V; v += kThreads)
      sumvec[v] = static_cast<i64>(rows[seed * stride + v]);
  __syncthreads();                    // every thread has read st
  if (threadIdx.x != 0) return;
  st[kIters] += 1;
  if (!ends) {
    st[kT] = t;
    return;
  }
  center_slot[c] = st[kLast];
  st[kMembers] += st[kCount];
  st[kC] = c + 1;
  if (stop) {
    st[kT] = t;
    st[kDone] = 1;
    return;
  }
  active[seed] = 0;
  owner[seed] = c + 1;
  stamp[seed] = t;
  st[kLast] = seed;
  st[kCount] = 1;
  st[kT] = t + 1;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points: launch on the caller's stream, return cudaGetLastError().
// `width` is the rows' element size in bytes (1, 2, 4 or 8).
// ---------------------------------------------------------------------------

extern "C" int mc_pa_window(void* st, const void* active, const void* ranges,
                            int n, void* stream) {
  pa_window_kernel<<<1, kWindowWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<i64*>(st), static_cast<const uint8_t*>(active),
      static_cast<const int*>(ranges), n);
  return cudaGetLastError();
}

template <typename T, int VEC>
static int launch_sums(cudaStream_t s, const i64* st, const uint8_t* act,
                       const void* rows, i64 pitch, i64 length, int n,
                       int with_dot, i64* out) {
  static const int blocks = resident_blocks(pa_sums_kernel<T, VEC>);
  const int nv = static_cast<int>(length / VEC);
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  pa_sums_kernel<T, VEC><<<blocks, kThreads, 0, s>>>(
      st, act, static_cast<const char*>(rows), pitch, nv, lanes, n, with_dot,
      out);
  return cudaGetLastError();
}

extern "C" int mc_pa_sums(const void* st, const void* active, const void* rows,
                          long long stride, int V, int width, int n,
                          int with_dot, void* sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64* st_ = static_cast<const i64*>(st);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  i64* out = static_cast<i64*>(sums);
  const i64 pitch = stride * width, length = static_cast<i64>(V) * width;
  const int vec = piece_bytes(rows, pitch, length, width);
#define MC_SUMS(T, VEC)                                              \
  case VEC:                                                          \
    return launch_sums<T, VEC>(s, st_, act, rows, pitch, length, n, \
                               with_dot, out)
  MC_ROW_CASES(MC_SUMS);
#undef MC_SUMS
}

template <typename T>
static void launch_absorb(cudaStream_t s, size_t smem, void* st,
                          const void* sums, int with_dot, const void* spec,
                          int n_spec, const void* coef, int n_coef,
                          const void* mag, const void* sq, const void* lenf,
                          void* owner, void* stamp, void* active,
                          const void* rows, long long stride, int V,
                          void* sumvec, int n, void* part) {
  static const int resident = resident_blocks(pa_absorb_kernel<T>);
  const int blocks = resident < kBlocks ? resident : kBlocks;
  pa_absorb_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<i64*>(st), static_cast<const i64*>(sums), with_dot,
      static_cast<const int*>(spec), n_spec, static_cast<const double*>(coef),
      n_coef, static_cast<const double*>(mag), static_cast<const double*>(sq),
      static_cast<const double*>(lenf), static_cast<i64*>(owner),
      static_cast<i64*>(stamp), static_cast<uint8_t*>(active),
      static_cast<const T*>(rows), stride, V, static_cast<i64*>(sumvec), n,
      static_cast<i64*>(part));
}

extern "C" int mc_pa_absorb(void* st, const void* sums, int with_dot,
                            const void* spec, int n_spec, const void* coef,
                            int n_coef, const void* mag, const void* sq,
                            const void* lenf, void* owner, void* stamp,
                            void* active, const void* rows, long long stride,
                            int V, int width, void* sumvec, int n,
                            void* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = n_coef * sizeof(double) + n_spec * sizeof(int);
#define MC_ABSORB(T)                                                         \
  launch_absorb<T>(s, smem, st, sums, with_dot, spec, n_spec, coef, n_coef, \
                   mag, sq, lenf, owner, stamp, active, rows, stride, V,     \
                   sumvec, n, part)
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

// Owner tiles of pa_move: one block a tile.
static int owner_tiles(int n) {
  return n > 0 ? (n + kTileSlots - 1) / kTileSlots : 1;
}

template <typename T, int VEC>
static int launch_move(cudaStream_t s, i64* st, const i64* own,
                       const void* rows, i64 pitch, int V, const i64* sv,
                       int n, const double* mag, const i64* stamp, i64* dist,
                       i64* part) {
  pa_move_kernel<T, VEC><<<owner_tiles(n), kThreads, 0, s>>>(
      st, own, static_cast<const char*>(rows), pitch, V, sv, n, mag, stamp,
      dist, part);
  return cudaGetLastError();
}

extern "C" int mc_pa_move(void* st, const void* owner, const void* rows,
                          long long stride, int V, int width,
                          const void* sumvec, int n, const void* mag,
                          const void* stamp, void* dist, void* part,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  i64* st_ = static_cast<i64*>(st);
  const i64* own = static_cast<const i64*>(owner);
  const i64* sv = static_cast<const i64*>(sumvec);
  const double* mag_ = static_cast<const double*>(mag);
  const i64* stamp_ = static_cast<const i64*>(stamp);
  i64* out = static_cast<i64*>(dist);
  i64* part_ = static_cast<i64*>(part);
  const i64 pitch = stride * width, length = static_cast<i64>(V) * width;
  const int vec = piece_bytes(rows, pitch, length, width);
#define MC_MOVE(T, VEC)                                                     \
  case VEC:                                                                 \
    return launch_move<T, VEC>(s, st_, own, rows, pitch, V, sv, n, mag_, \
                               stamp_, out, part_)
  MC_ROW_CASES(MC_MOVE);
#undef MC_MOVE
}
#undef MC_ROW_CASES

extern "C" int mc_pa_next(void* st, void* active, void* owner, void* stamp,
                          const void* rows, long long stride, int V, int width,
                          void* sumvec, void* center_slot, int n,
                          long long cmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_NEXT(T)                                                           \
  pa_next_kernel<T><<<1, kThreads, 0, s>>>(                                  \
      static_cast<i64*>(st), static_cast<uint8_t*>(active),                  \
      static_cast<i64*>(owner), static_cast<i64*>(stamp),                    \
      static_cast<const T*>(rows), stride, V, static_cast<i64*>(sumvec),     \
      static_cast<i64*>(center_slot), n, cmax)
  switch (width) {
    case 1: MC_NEXT(int8_t); break;
    case 2: MC_NEXT(int16_t); break;
    case 4: MC_NEXT(int32_t); break;
    case 8: MC_NEXT(int64_t); break;
    default: return cudaErrorInvalidValue;
  }
#undef MC_NEXT
  return cudaGetLastError();
}
