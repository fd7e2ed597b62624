// GlobAlignE affine-gap global alignment kernel for Hopper (sm_90a): one
// pair per CTA, the DP rows of a strip spread over the CTA's threads. It
// aligns every pair of the port, short read or genome.
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
// bases, 78 for an N outside a segment; N equals N. State is nine unpacked
// int32 values a cell (score, path length, matches for each of M, UG, LG),
// exact while l1 + l2 < 2^31: there is no length gate.
//
// Layout: the DP is cut into horizontal strips of kT rows; thread t of the
// CTA owns row r0 + t + 1 of the strip at r0 and sweeps all columns of b in
// a skewed wavefront, column j at step j + t. A cell needs its own row's
// cell to the left (kept in registers), and row i-1's cells at columns j-1
// and j. Row i-1 belongs to thread t-1, which computed column j one step
// earlier and column j-1 two steps earlier: each step thread t takes thread
// t-1's newest cell (by __shfl_up_sync inside a warp; across warps through a
// double-buffered shared-memory slot written by lane 31), and the cell it
// took the step before becomes its diagonal. Thread 0 takes row r0 from the
// per-pair boundary buffer in device memory, which the strip's last thread
// overwrites, column by column, with row r0 + kT for the next strip; the
// TPU kernel's left-column scratch and corner stash have no counterpart,
// because a strip spans every column.
//
// Device memory per pair: the boundary row, 9 int32 planes x (l2 + 1), 36
// bytes a column, independent of l1 (the TPU kernel carried the same row
// through HBM between strips).
//
// Bound: integer ALU per cell (three max/select chains), plus the per-step
// hand-off (nine shuffles and one __syncthreads) that serialises the
// wavefront; the boundary row is read once and written once per strip. The
// design spends the CTA's 128 threads on one pair so that a launch of a few
// hundred pairs still fills the card; thread 0 reads the boundary row
// through a shared-memory chunk that all threads load, coalesced, once every
// kT steps, so the per-step critical path never waits on device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;  // threads per CTA = DP rows per strip
constexpr int kWarps = kT / 32;
constexpr int kPlanes = 9;
constexpr unsigned kFull = 0xffffffffu;

struct Cell {
  int m, ug, lg;  // scores
  int ml, ul, ll;  // path lengths
  int mi, ui, li;  // matches
};

// Boundary cell (i, j) with i == 0 or j == 0: the reference's column 0
// (rows i >= 1) and row 0 (columns j >= 0) initialisation
// (GlobAlignE.cpp:129-168), as meshclust_tpu/ops/align_tiled.py:206-223
// applies it. The origin's UG (-go here, negativeInf there) never decides
// cell (1, 1): M(0, 0) = 0 is larger.
__device__ __forceinline__ Cell boundary(int i, int j, int neg, int go,
                                         int gc) {
  Cell c;
  if (i == 0) {
    c.m = j == 0 ? 0 : neg;
    c.ug = -go - j * gc;
    c.lg = neg;
    c.ml = c.ul = c.ll = j;
  } else {
    c.m = neg;
    c.ug = neg;
    c.lg = -go - i * gc;
    c.ml = c.ul = c.ll = i;
  }
  c.mi = c.ui = c.li = 0;
  return c;
}

// Cell (i, j) from (i, j-1) `left`, (i-1, j-1) `diag` and (i-1, j) `up`.
__device__ __forceinline__ Cell dp_cell(const Cell& left, const Cell& diag,
                                        const Cell& up, bool same, int match,
                                        int mismatch, int gap, int gc) {
  Cell c;
  // UG(i, j) from (i, j-1): gap-begin over gap-continue.
  const int yb = left.m - gap;
  c.ug = max(yb, left.ug - gc);
  const bool ug_begin = c.ug == yb;
  c.ul = ug_begin ? left.ml + 1 : left.ul + 1;
  c.ui = ug_begin ? left.mi : left.ui;

  // M(i, j) from (i-1, j-1): matched > xgap_end > ygap_end.
  const int s = same ? match : mismatch;
  const int inc = s == match ? 1 : 0;
  const int matched = diag.m + s;
  const int xe = diag.lg + s;
  const int ye = diag.ug + s;
  c.m = max(max(matched, xe), ye);
  if (c.m == matched) {
    c.ml = diag.ml + 1;
    c.mi = diag.mi + inc;
  } else if (c.m == xe) {
    c.ml = diag.ll + 1;
    c.mi = diag.li + inc;
  } else {
    c.ml = diag.ul + 1;
    c.mi = diag.ui + inc;
  }

  // LG(i, j) from (i-1, j): gap-begin over gap-continue.
  const int xb = up.m - gap;
  c.lg = max(xb, up.lg - gc);
  const bool lg_begin = c.lg == xb;
  c.ll = lg_begin ? up.ml + 1 : up.ll + 1;
  c.li = lg_begin ? up.mi : up.li;
  return c;
}

__device__ __forceinline__ Cell shfl_up1(const Cell& c) {
  Cell o;
  o.m = __shfl_up_sync(kFull, c.m, 1);
  o.ug = __shfl_up_sync(kFull, c.ug, 1);
  o.lg = __shfl_up_sync(kFull, c.lg, 1);
  o.ml = __shfl_up_sync(kFull, c.ml, 1);
  o.ul = __shfl_up_sync(kFull, c.ul, 1);
  o.ll = __shfl_up_sync(kFull, c.ll, 1);
  o.mi = __shfl_up_sync(kFull, c.mi, 1);
  o.ui = __shfl_up_sync(kFull, c.ui, 1);
  o.li = __shfl_up_sync(kFull, c.li, 1);
  return o;
}

__device__ __forceinline__ void put(int* dst, long long step, const Cell& c) {
  dst[0 * step] = c.m;
  dst[1 * step] = c.ug;
  dst[2 * step] = c.lg;
  dst[3 * step] = c.ml;
  dst[4 * step] = c.ul;
  dst[5 * step] = c.ll;
  dst[6 * step] = c.mi;
  dst[7 * step] = c.ui;
  dst[8 * step] = c.li;
}

__device__ __forceinline__ Cell get(const int* src, long long step) {
  Cell c;
  c.m = src[0 * step];
  c.ug = src[1 * step];
  c.lg = src[2 * step];
  c.ml = src[3 * step];
  c.ul = src[4 * step];
  c.ll = src[5 * step];
  c.mi = src[6 * step];
  c.ui = src[7 * step];
  c.li = src[8 * step];
  return c;
}

__global__ void __launch_bounds__(kT) nw_align_long_kernel(
    const int8_t* __restrict__ codes, long long lpad,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ ia,
    const int32_t* __restrict__ ib, int stride, int match, int mismatch,
    int go, int gc, int32_t* __restrict__ bnd, int32_t* __restrict__ alen,
    int32_t* __restrict__ amatch) {
  // hand[s & 1][w]: lane 31 of warp w at step s, for lane 0 of warp w + 1.
  __shared__ int hand[2][kWarps][kPlanes];
  // top[f][c - c0]: row r0 at columns c0 .. c0 + kT - 1 (strips r0 > 0).
  __shared__ int top[kPlanes][kT];

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

  for (int r0 = 0; r0 < l1; r0 += kT) {
    const int nrows = min(kT, l1 - r0);
    const bool writes_row = r0 + kT < l1;  // another strip follows
    const bool row_ok = t < nrows;
    const int i = r0 + t + 1;
    const int ai = row_ok ? a[i - 1] : -1;

    // Columns c0 .. c0 + kT - 1 of row r0 into `top`, one column a thread.
    auto load_top = [&](int c0) {
      const int c = c0 + t;
      if (c <= l2) {
        for (int f = 0; f < kPlanes; ++f) top[f][t] = row[f * stride + c];
      }
    };
    // Row r0 at column c >= 1, as thread 0 needs it.
    auto top_at = [&](int c) {
      return r0 == 0 ? boundary(0, c, neg, go, gc)
                     : get(&top[0][(c - 1) % kT], kT);
    };

    if (r0 > 0) load_top(1);
    __syncthreads();
    Cell left = boundary(i, 0, neg, go, gc);  // (i, j-1), j = 1
    Cell up, diag;                            // (i-1, j), (i-1, j-1)
    if (t == 0) {
      diag = boundary(r0, 0, neg, go, gc);
      up = top_at(1);
    } else {
      // thread t-1 has not started either: its cell is (i-1, 0)
      up = boundary(i - 1, 0, neg, go, gc);
      diag = up;
    }

    const int nsteps = nrows - 1 + l2;
    for (int s = 1; s <= nsteps; ++s) {
      const int j = s - t;
      if (row_ok && j >= 1 && j <= l2) {
        left = dp_cell(left, diag, up, ai == b[j - 1], match, mismatch, gap,
                       gc);
        if (writes_row && t == kT - 1) put(row + j, stride, left);
        if (i == l1 && j == l2) {
          // Readout at cell (l1, l2): M > LG > UG.
          const int score = max(max(left.m, left.lg), left.ug);
          if (score == left.m) {
            alen[p] = left.ml;
            amatch[p] = left.mi;
          } else if (score == left.lg) {
            alen[p] = left.ll;
            amatch[p] = left.li;
          } else {
            alen[p] = left.ul;
            amatch[p] = left.ui;
          }
        }
      }
      if (lane == 31) put(&hand[s & 1][warp][0], 1, left);
      Cell v = shfl_up1(left);
      if (r0 > 0 && s % kT == 0 && s < l2) {
        // Thread 0 read the old chunk's last column in step s - 1.
        __syncthreads();
        load_top(s + 1);
      }
      __syncthreads();
      if (lane == 0) {
        if (warp > 0) {
          v = get(&hand[s & 1][warp - 1][0], 1);
        } else if (s < l2) {
          v = top_at(s + 1);
        }
      }
      diag = up;
      up = v;
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
