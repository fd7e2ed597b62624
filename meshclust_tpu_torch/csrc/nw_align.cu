// GlobAlignE affine-gap global alignment kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel meshclust_tpu/ops/align_window.py:_win_kernel
// (driven by win_grid_call through DeviceAligner), and with it the full-row
// variants ops/align_device.py:_grid_kernel and ops/align_pallas.py:_kernel,
// which compute the same function.
//
// Semantics: MeShClust's GlobAlignE::findAlignment (match, mismatch, gap
// open, gap extend; 1, -1, 2, 1 on the main path), transcribed in
// tests/ref_impl.py:glob_align. For each pair (a, b) it returns the length of
// the chosen alignment and its number of matches. Tie-breaks are the
// reference's: upper/lower gap prefers gap-begin over gap-continue; the
// match cell prefers matched > xgap_end (lower) > ygap_end (upper); the
// readout prefers M > LG > UG. The sentinel "negativeInf" is the reference's
// finite value (meshclust_tpu/ops/align.py:neg_inf_sentinel). Codes are
// bytes: 0..3 for bases, 78 for an N outside a segment; N equals N.
//
// Layout: one thread per pair sweeps the DP column by column (one column per
// base of b), rows 1..l1 inside, exactly as the reference's rolling two-pass
// loop but fused into one pass: the lower-gap row recurrence only needs the
// values of row i-1 of the same column, which the thread keeps in registers.
// The nine O(l1) state rows (score, path length, matches for each of M, UG,
// LG) live in global scratch laid out [plane][row][pair], so the 32 threads
// of a warp touch 32 neighbouring words. State is unpacked int32: exact while
// l1 + l2 < 2^31 (the TPU kernel packed length and matches into one int32 and
// was gated at l1 + l2 <= 32,765 and l1 <= 8,192; this kernel has no gate).
//
// Bound: integer ALU and the scratch traffic, 9 int32 read and 9 written per
// cell (72 bytes a cell). The scratch of a chunk is 36 bytes x rows x pairs;
// pairs are sorted by l1 + l2 by the caller so the threads of a warp finish
// together.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) nw_align_kernel(
    const int8_t* __restrict__ codes, long long lpad,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ ia,
    const int32_t* __restrict__ ib, int P, int R, int match, int mismatch,
    int go, int gc, int32_t* __restrict__ scratch,
    int32_t* __restrict__ alen, int32_t* __restrict__ amatch) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int l1 = lengths[ia[p]];
  const int l2 = lengths[ib[p]];
  if (l1 < 1 || l2 < 1 || l1 > R) {  // the caller promised 1 <= l1 <= R
    alen[p] = -1;
    amatch[p] = -1;
    return;
  }
  const int8_t* a = codes + static_cast<long long>(ia[p]) * lpad;
  const int8_t* b = codes + static_cast<long long>(ib[p]) * lpad;

  const long long plane = static_cast<long long>(R) * P;
  int32_t* __restrict__ M = scratch + p;
  int32_t* __restrict__ UG = M + plane;
  int32_t* __restrict__ LG = UG + plane;
  int32_t* __restrict__ Ml = LG + plane;
  int32_t* __restrict__ Ul = Ml + plane;
  int32_t* __restrict__ Ll = Ul + plane;
  int32_t* __restrict__ Mi = Ll + plane;
  int32_t* __restrict__ Ui = Mi + plane;
  int32_t* __restrict__ Li = Ui + plane;

  const int shorter = l1 < l2 ? l1 : l2;
  const int diff = l1 > l2 ? l1 - l2 : l2 - l1;
  const int neg = mismatch * shorter - 1 - (diff >= 1 ? go + diff * gc : 0);
  const int gap = go + gc;

  // Column 0 (rows 1..l1; row 0 is implied by the column index below).
  for (int i = 1; i <= l1; ++i) {
    const long long o = static_cast<long long>(i - 1) * P;
    M[o] = neg;
    UG[o] = neg;
    LG[o] = -go - i * gc;
    Ml[o] = i;
    Ul[o] = i;
    Ll[o] = i;
    Mi[o] = 0;
    Ui[o] = 0;
    Li[o] = 0;
  }

  for (int j = 1; j <= l2; ++j) {
    const int bj = b[j - 1];
    // Row 0 of column j-1 (M, upper gap, lower gap) ...
    int m_lag = j == 1 ? 0 : neg, ml_lag = j - 1, mi_lag = 0;
    int ug_lag = -go - (j - 1) * gc, ul_lag = j - 1, ui_lag = 0;
    int lg_lag = neg, ll_lag = j - 1, li_lag = 0;
    // ... and row 0 of column j, the "previous row" of the lower gap.
    int m_up = neg, ml_up = j, mi_up = 0;
    int lg_up = neg, ll_up = j, li_up = 0;
    for (int i = 1; i <= l1; ++i) {
      const long long o = static_cast<long long>(i - 1) * P;
      const int m_old = M[o], ug_old = UG[o], lg_old = LG[o];
      const int ml_old = Ml[o], ul_old = Ul[o], ll_old = Ll[o];
      const int mi_old = Mi[o], ui_old = Ui[o], li_old = Li[o];

      // UG(i, j) from (i, j-1): gap-begin over gap-continue.
      const int yb = m_old - gap;
      const int ug = max(yb, ug_old - gc);
      const bool ug_begin = ug == yb;
      const int ul = ug_begin ? ml_old + 1 : ul_old + 1;
      const int ui = ug_begin ? mi_old : ui_old;

      // M(i, j) from (i-1, j-1): matched > xgap_end > ygap_end.
      const int s = a[i - 1] == bj ? match : mismatch;
      const int inc = s == match ? 1 : 0;
      const int matched = m_lag + s;
      const int xe = lg_lag + s;
      const int ye = ug_lag + s;
      const int m = max(max(matched, xe), ye);
      int ml, mi;
      if (m == matched) {
        ml = ml_lag + 1;
        mi = mi_lag + inc;
      } else if (m == xe) {
        ml = ll_lag + 1;
        mi = li_lag + inc;
      } else {
        ml = ul_lag + 1;
        mi = ui_lag + inc;
      }

      // LG(i, j) from (i-1, j): gap-begin over gap-continue.
      const int xb = m_up - gap;
      const int lg = max(xb, lg_up - gc);
      const bool lg_begin = lg == xb;
      const int ll = lg_begin ? ml_up + 1 : ll_up + 1;
      const int li = lg_begin ? mi_up : li_up;

      m_lag = m_old; ml_lag = ml_old; mi_lag = mi_old;
      ug_lag = ug_old; ul_lag = ul_old; ui_lag = ui_old;
      lg_lag = lg_old; ll_lag = ll_old; li_lag = li_old;
      m_up = m; ml_up = ml; mi_up = mi;
      lg_up = lg; ll_up = ll; li_up = li;

      M[o] = m; UG[o] = ug; LG[o] = lg;
      Ml[o] = ml; Ul[o] = ul; Ll[o] = ll;
      Mi[o] = mi; Ui[o] = ui; Li[o] = li;
    }
  }

  // Readout at cell (l1, l2): M > LG > UG.
  const long long o = static_cast<long long>(l1 - 1) * P;
  const int fm = M[o], flg = LG[o], fug = UG[o];
  const int score = max(max(fm, flg), fug);
  if (score == fm) {
    alen[p] = Ml[o];
    amatch[p] = Mi[o];
  } else if (score == flg) {
    alen[p] = Ll[o];
    amatch[p] = Li[o];
  } else {
    alen[p] = Ul[o];
    amatch[p] = Ui[o];
  }
}

}  // namespace

// codes [N, lpad] int8 (staged corpus); lengths [N] int32; ia, ib [P] int32
// row indices into codes; scratch [9, R, P] int32 with R >= every l1;
// alen, amatch [P] int32. A pair whose lengths break 1 <= l1 <= R and
// l2 >= 1 gets alen = amatch = -1. Returns cudaGetLastError() after the
// launch.
extern "C" int mc_nw_align(const void* codes, long long lpad,
                           const void* lengths, const void* ia, const void* ib,
                           int P, int R, int match, int mismatch, int go,
                           int gc, void* scratch, void* alen, void* amatch,
                           void* stream) {
  if (P <= 0) return cudaSuccess;
  const int blocks = (P + kThreads - 1) / kThreads;
  nw_align_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), lpad,
      static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(ia),
      static_cast<const int32_t*>(ib), P, R, match, mismatch, go, gc,
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(alen),
      static_cast<int32_t*>(amatch));
  return cudaGetLastError();
}

extern "C" const char* mc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
