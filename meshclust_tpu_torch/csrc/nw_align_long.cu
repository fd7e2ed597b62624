// GlobAlignE affine-gap global alignment kernel for Hopper (sm_90a): one
// pair per CTA, several DP rows per thread. It aligns every pair of the
// port, short read or genome.
//
// Replaces the TPU kernel meshclust_tpu/ops/align_tiled.py:_tile_kernel
// (driven by _align_tiled and align_long_batch), which the JAX package's
// DeviceAligner takes for pairs past its short kernels' gate (l1 > 8,192 or
// l1 + l2 + 2 > 32,767), and with it the short-pair kernels
// ops/align_window.py:_win_kernel, ops/align_device.py:_grid_kernel and
// ops/align_pallas.py:_kernel, which compute the same function.
//
// Semantics: MeShClust's GlobAlignE::findAlignment (match, mismatch, gap
// open, gap extend; 1, -1, 2, 1 on the main path), transcribed in
// tests/ref_impl.py:glob_align. For each pair (a, b) it returns the length of
// the chosen alignment and its number of matches. Tie-breaks are the
// reference's: upper/lower gap prefers gap-begin over gap-continue; the
// match cell prefers matched > xgap_end (lower) > ygap_end (upper); the
// readout prefers M > LG > UG. "negativeInf" is the reference's finite value
// (meshclust_tpu/ops/align.py:neg_inf_sentinel). Codes are bytes: 0..3 for
// bases, 78 for an N outside a segment; N equals N.
//
// State: each of M, UG, LG carries (score, diagonal steps D, substitution
// sum X) as int32. A path to (i, j) with D diagonal steps has length
// i + j - D (each gap step adds one to i + j, each diagonal two), and X, the
// sum of its substitution scores, is n * match + (D - n) * mismatch for n
// matches. So the readout returns l1 + l2 - D and n = (X - D * mismatch) /
// (match - mismatch) (n = D when match == mismatch); the gap transitions
// need no "+ 1" and the match cell adds its score to X, with no compare for
// a match count. Exact while l1 + l2 < 2^31: there is no length gate.
//
// Layout: the DP is cut into horizontal strips of kStrip = kR * kT rows.
// Thread t owns the kR consecutive rows q = kR * t + r (r < kR) of a strip
// and row q computes column j at step j + q + kLag * warp: a wavefront
// skewed by one column a row, so at each step the kR rows of a thread are
// at kR different columns and their cells are independent (kR-way ILP for
// the max/select chain, which the genome path's launches of ~163 pairs run
// at one warp per SM sub-partition). Row r
// takes its upper and diagonal neighbours from row r - 1 of the same thread
// (its cells of the last two steps, in registers); only row 0 takes a
// message from the row above it in thread t - 1: by __shfl_up_sync inside a
// warp, through a ring of shared-memory slots between warps, and from the
// per-pair boundary row in device memory for thread 0. Warp w trails warp
// w - 1 by kLag = kK - 1 extra steps, so a slot is read kK steps after it is
// written and the CTA needs one __syncthreads every kK steps, not every
// step. A message is what row i - 1's cell (i - 1, j) gives row i: LG(i, j)
// and the best of (i - 1, j)'s three states, to which M(i, j + 1) adds its
// substitution score (adding the same score to all three leaves the choice
// unchanged): six int32 values, so the shuffles, the slot and the barrier
// are paid once per kR cells. The max/select steps are written with the DPX
// intrinsic __vibmax_s32, whose predicate (a >= b) carries the tie-breaks;
// nvcc 12.9 lowers it to ISETP.GE + SEL for sm_90a, with no DPX opcode.
//
// Device memory per pair: the boundary row between strips, 9 int32 planes x
// (l2 + 1), 36 bytes a column, independent of l1 (the TPU kernel carried the
// same row through HBM between strips). The strip's last row writes it,
// thread 0 of the next strip reads it through a double-buffered chunk of kT
// messages that all threads load, coalesced, once every kT steps.
//
// Bound: integer operations on the ALU pipe; the bytes (codes in, two int32
// out per pair) are negligible. Each of the cell's four choices (UG, LG, and
// the two compares of the best state) is one compare and three selects
// (score, D, X), and the substitution score is a compare and a select: 18
// compares and selects a cell, which only the ALU pipe (16 lanes per SM
// sub-partition: 132 SMs x 64 x 1.98 GHz = 16.7 Tops/s on an H100 SXM)
// runs. The cell's 7 adds can also run on the FMA pipe, and all 25
// operations fit the 128 lanes an SM dispatches per cycle in less time, so
// the bound is 18 operations a cell at 16.7 Tops/s, 0.93 Tcells/s. The
// design cuts everything else a step spends per cell: one hand-off and at
// most one barrier share kR (and kK) cells, b
// arrives through a shift register of kR codes (one load a step) and a's kR
// codes load once per strip. Each strip pays l2 + kStrip - 1 steps plus the
// warps' lag, so short pairs fit one strip and never touch the boundary row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The kernel's shape, mirrored by ops/align_device.py.
constexpr int kR = 8;            // DP rows per thread
constexpr int kT = 128;          // threads per CTA
constexpr int kStrip = kR * kT;  // DP rows per strip
constexpr int kK = 8;            // steps between barriers
constexpr int kLag = kK - 1;     // extra steps warp w trails warp w - 1
constexpr int kRing = 2 * kK;    // hand-off slots per warp
constexpr int kWarps = kT / 32;
constexpr int kPlanes = 9;
constexpr int kMsg = 6;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kT % 32 == 0 && (kT & (kT - 1)) == 0, "kT: power of two");
static_assert(kK >= 1 && (kK & (kK - 1)) == 0 && kT % kK == 0,
              "kK: a power of two dividing kT");

struct State {
  int s, d, x;  // score, diagonal steps, sum of substitution scores
};

struct Cell {
  State m, ug, lg;
};

// What cell (i - 1, j) gives row i: LG(i, j), and the best state of
// (i - 1, j) for M(i, j + 1).
struct Msg {
  State lg, best;
};

// Boundary cell (i, j) with i == 0 or j == 0: the reference's column 0
// (rows i >= 1) and row 0 (columns j >= 0) initialisation
// (GlobAlignE.cpp:129-168), as meshclust_tpu/ops/align_tiled.py:206-223
// applies it; every boundary path is all gaps (no diagonal step). The
// origin's UG (-go here, negativeInf there) never decides cell (1, 1):
// M(0, 0) = 0 is larger.
__device__ __forceinline__ Cell boundary(int i, int j, int neg, int go,
                                         int gc) {
  Cell c;
  if (i == 0) {
    c.m.s = j == 0 ? 0 : neg;
    c.ug.s = -go - j * gc;
    c.lg.s = neg;
  } else {
    c.m.s = neg;
    c.ug.s = neg;
    c.lg.s = -go - i * gc;
  }
  c.m.d = c.ug.d = c.lg.d = 0;
  c.m.x = c.ug.x = c.lg.x = 0;
  return c;
}

// A gap state from the cell it extends (`g` is that cell's state of the same
// gap): gap-begin from M over gap-continue, begin on a tie.
__device__ __forceinline__ State gap_from(const Cell& c, const State& g,
                                          int gap, int gc) {
  bool begin;
  State o;
  o.s = __vibmax_s32(c.m.s - gap, g.s - gc, &begin);
  o.d = begin ? c.m.d : g.d;
  o.x = begin ? c.m.x : g.x;
  return o;
}

// The best of M > LG > UG: the match cell's choice of predecessor and the
// readout.
__device__ __forceinline__ State best(const Cell& c) {
  bool m_ge_lg, first_ge_ug;
  const int s = __vibmax_s32(c.m.s, c.lg.s, &m_ge_lg);
  State o;
  o.s = __vibmax_s32(s, c.ug.s, &first_ge_ug);
  const int d = m_ge_lg ? c.m.d : c.lg.d;
  const int x = m_ge_lg ? c.m.x : c.lg.x;
  o.d = first_ge_ug ? d : c.ug.d;
  o.x = first_ge_ug ? x : c.ug.x;
  return o;
}

__device__ __forceinline__ Msg message(const Cell& c, int gap, int gc) {
  return Msg{gap_from(c, c.lg, gap, gc), best(c)};
}

// Cell (i, j) in place of `left` = (i, j - 1), from `in` = the message of
// (i - 1, j) and `prev` = the best state of (i - 1, j - 1), which becomes
// in.best for the next column.
__device__ __forceinline__ void dp_cell(Cell& left, State& prev,
                                        const Msg& in, bool same, int match,
                                        int mismatch, int gap, int gc) {
  const int sc = same ? match : mismatch;
  left.ug = gap_from(left, left.ug, gap, gc);
  left.lg = in.lg;
  left.m.s = prev.s + sc;
  left.m.d = prev.d + 1;
  left.m.x = prev.x + sc;
  prev = in.best;
}

__device__ __forceinline__ void put_cell(int* dst, long long step,
                                         const Cell& c) {
  dst[0 * step] = c.m.s;
  dst[1 * step] = c.ug.s;
  dst[2 * step] = c.lg.s;
  dst[3 * step] = c.m.d;
  dst[4 * step] = c.ug.d;
  dst[5 * step] = c.lg.d;
  dst[6 * step] = c.m.x;
  dst[7 * step] = c.ug.x;
  dst[8 * step] = c.lg.x;
}

__device__ __forceinline__ Cell get_cell(const int* src, long long step) {
  Cell c;
  c.m.s = src[0 * step];
  c.ug.s = src[1 * step];
  c.lg.s = src[2 * step];
  c.m.d = src[3 * step];
  c.ug.d = src[4 * step];
  c.lg.d = src[5 * step];
  c.m.x = src[6 * step];
  c.ug.x = src[7 * step];
  c.lg.x = src[8 * step];
  return c;
}

__device__ __forceinline__ void put_msg(int* dst, int step, const Msg& m) {
  dst[0 * step] = m.lg.s;
  dst[1 * step] = m.lg.d;
  dst[2 * step] = m.lg.x;
  dst[3 * step] = m.best.s;
  dst[4 * step] = m.best.d;
  dst[5 * step] = m.best.x;
}

__device__ __forceinline__ Msg get_msg(const int* src, int step) {
  Msg m;
  m.lg.s = src[0 * step];
  m.lg.d = src[1 * step];
  m.lg.x = src[2 * step];
  m.best.s = src[3 * step];
  m.best.d = src[4 * step];
  m.best.x = src[5 * step];
  return m;
}

__device__ __forceinline__ Msg shfl_up1(const Msg& m) {
  Msg o;
  o.lg.s = __shfl_up_sync(kFull, m.lg.s, 1);
  o.lg.d = __shfl_up_sync(kFull, m.lg.d, 1);
  o.lg.x = __shfl_up_sync(kFull, m.lg.x, 1);
  o.best.s = __shfl_up_sync(kFull, m.best.s, 1);
  o.best.d = __shfl_up_sync(kFull, m.best.d, 1);
  o.best.x = __shfl_up_sync(kFull, m.best.x, 1);
  return o;
}

__global__ void __launch_bounds__(kT) nw_align_long_kernel(
    const int8_t* __restrict__ codes, long long lpad,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ ia,
    const int32_t* __restrict__ ib, int stride, int match, int mismatch,
    int go, int gc, int32_t* __restrict__ bnd, int32_t* __restrict__ alen,
    int32_t* __restrict__ amatch) {
  // ring[g % kRing][w]: lane 31 of warp w at step g, for lane 0 of warp
  // w + 1 at step g + kK.
  __shared__ int ring[kRing][kWarps][kMsg];
  // top[c & 1][f][x]: message of row r0 at column c * kT + 1 + x.
  __shared__ int top[2][kMsg][kT];

  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int l1 = lengths[ia[p]];
  const int l2 = lengths[ib[p]];
  if (l1 < 1 || l2 < 1 || l2 >= stride) {  // the caller promised otherwise
    if (t == 0) {
      alen[p] = -1;
      amatch[p] = -1;
    }
    return;
  }
  const int8_t* a = codes + static_cast<long long>(ia[p]) * lpad;
  const int8_t* b = codes + static_cast<long long>(ib[p]) * lpad;
  // Plane f of this pair's boundary row, column j: row[f * stride + j].
  int32_t* __restrict__ row = bnd + static_cast<long long>(p) * kPlanes * stride;

  const int shorter = l1 < l2 ? l1 : l2;
  const int diff = l1 > l2 ? l1 - l2 : l2 - l1;
  const int neg = mismatch * shorter - 1 - (diff >= 1 ? go + diff * gc : 0);
  const int gap = go + gc;
  const int q0 = kR * t;               // this thread's first row in a strip
  const int base = q0 + kLag * warp;   // row r computes column g - base - r

  for (int r0 = 0; r0 < l1; r0 += kStrip) {
    const int nrows = min(kStrip, l1 - r0);
    const bool writes_row = r0 + kStrip < l1;  // another strip follows
    const bool rows_ok = q0 + kR <= nrows;     // all kR rows are in the strip

    // Messages of row r0 at columns c * kT + 1 .. (c + 1) * kT.
    auto load_top = [&](int c) {
      const int col = c * kT + 1 + t;
      if (col <= l2) {
        const Cell x = r0 == 0 ? boundary(0, col, neg, go, gc)
                               : get_cell(row + col, stride);
        put_msg(&top[c & 1][0][t], kT, message(x, gap, gc));
      }
    };

    int ar[kR];     // a's codes of the kR rows
    int bq[kR];     // bq[r] = b[g - base - r - 1] at step g
    Cell cell[kR];  // row r's newest cell (column 0 before its first step)
    State prev[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = r0 + q0 + r + 1;
      ar[r] = q0 + r < nrows ? a[i - 1] : -1;
      bq[r] = -2;
      cell[r] = boundary(i, 0, neg, go, gc);
      prev[r] = best(boundary(i - 1, 0, neg, go, gc));
    }
    int bnext = b[min(max(-base, 0), l2 - 1)];
    Msg in = message(cell[0], gap, gc);  // replaced before row 0 needs it
    load_top(0);
    __syncthreads();

    const int tl = (nrows - 1) / kR;  // the thread of the strip's last row
    const int nsteps = l2 + nrows - 1 + kLag * (tl >> 5);
    for (int g = 1; g <= nsteps; ++g) {
      // Row 0's message: from row r0 for thread 0, from warp - 1's lane 31
      // kK steps ago for lane 0, else the shuffle of the step before.
      if (t == 0) {
        if (g <= l2) {
          in = get_msg(&top[((g - 1) / kT) & 1][0][(g - 1) & (kT - 1)], kT);
        }
      } else if (lane == 0) {
        in = get_msg(&ring[(g - kK) & (kRing - 1)][warp - 1][0], 1);
      }
#pragma unroll
      for (int r = kR - 1; r > 0; --r) bq[r] = bq[r - 1];
      bq[0] = bnext;
      bnext = b[min(max(g - base, 0), l2 - 1)];

      const int j0 = g - base;  // row 0's column
      // All kR rows inside the DP (most steps of a long pair), without the
      // per-row guards: one guarded loop for every step was measured slower.
      if (rows_ok && j0 - (kR - 1) >= 1 && j0 <= l2) {
#pragma unroll
        for (int r = kR - 1; r >= 0; --r) {
          const Msg m = r > 0 ? message(cell[r - 1], gap, gc) : in;
          dp_cell(cell[r], prev[r], m, ar[r] == bq[r], match, mismatch, gap,
                  gc);
        }
      } else {
#pragma unroll
        for (int r = kR - 1; r >= 0; --r) {
          const int j = j0 - r;
          if (q0 + r < nrows && j >= 1 && j <= l2) {
            const Msg m = r > 0 ? message(cell[r - 1], gap, gc) : in;
            dp_cell(cell[r], prev[r], m, ar[r] == bq[r], match, mismatch,
                    gap, gc);
          }
        }
      }
      const int jl = j0 - (kR - 1);  // the last row's column
      if (writes_row && t == kT - 1 && jl >= 1 && jl <= l2) {
        put_cell(row + jl, stride, cell[kR - 1]);
      }

      const Msg out = message(cell[kR - 1], gap, gc);
      if (lane == 31 && warp + 1 < kWarps) {
        put_msg(&ring[g & (kRing - 1)][warp][0], 1, out);
      }
      in = shfl_up1(out);
      if (((g - 1) & (kT - 1)) == 0) load_top((g - 1) / kT + 1);
      if ((g & (kK - 1)) == 0) __syncthreads();
    }

    if (!writes_row) {
      // Readout at cell (l1, l2), held by the strip's row l1 - 1 - r0.
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (q0 + r == nrows - 1) {
          const State o = best(cell[r]);
          alen[p] = l1 + l2 - o.d;
          amatch[p] = match == mismatch ? o.d
                                        : (o.x - o.d * mismatch) /
                                              (match - mismatch);
        }
      }
    }
    // The boundary row and `top` are complete before the next strip.
    __syncthreads();
  }
}

}  // namespace

// codes [N, lpad] int8 (staged corpus); lengths [N] int32; ia, ib [P] int32
// row indices into codes; bnd [P, 9, stride] int32 boundary rows with
// stride > every l2; alen, amatch [P] int32. A pair whose lengths break
// l1 >= 1 and 1 <= l2 < stride gets alen = amatch = -1. Returns
// cudaGetLastError() after the launch.
extern "C" int mc_nw_align_long(const void* codes, long long lpad,
                                const void* lengths, const void* ia,
                                const void* ib, int P, int stride, int match,
                                int mismatch, int go, int gc, void* bnd,
                                void* alen, void* amatch, void* stream) {
  if (P <= 0) return cudaSuccess;
  nw_align_long_kernel<<<P, kT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), lpad,
      static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(ia),
      static_cast<const int32_t*>(ib), stride, match, mismatch, go, gc,
      static_cast<int32_t*>(bnd), static_cast<int32_t*>(alen),
      static_cast<int32_t*>(amatch));
  return cudaGetLastError();
}

extern "C" const char* mc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
