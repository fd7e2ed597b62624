// Bulk bvec insertion: compute the target bin for every point, replicating
// the sequential least-filled-eligible-bin rule (see core/bvec.py BVec.insert,
// re-designed from the reference's bvec::insert semantics, bvec.cpp:152-177)
// without the O(N * nbins) Python cost that made 1M-point runs crawl.
//
//   - eligible bin range [front, back] per length: the index_of linear-scan
//     rule over begin_bounds (bvec.cpp:122-149), memoized per distinct length
//     (lengths repeat heavily in read sets);
//   - among eligible bins, the least-filled one wins; on ties the MIDDLE
//     (index count/2) of the minimal bins is chosen. A segment tree over bin
//     sizes answers (range-min, count-of-min, k-th-min-occurrence) in
//     O(log nbins) per insert, so the whole pass is O(N log nbins).
//
// C ABI: mc_bvec_targets(lengths[N], N, bounds[nb], nb, out_targets[N]).
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct SegTree {
  // min bin size + count of minima per node; leaves are bins.
  int n;
  std::vector<int64_t> mn;
  std::vector<int32_t> cnt;
  explicit SegTree(int nbins) : n(1) {
    while (n < nbins) n <<= 1;
    mn.assign(2 * n, INT64_MAX);
    cnt.assign(2 * n, 0);
    for (int i = 0; i < nbins; i++) { mn[n + i] = 0; cnt[n + i] = 1; }
    for (int i = n - 1; i >= 1; i--) pull(i);
  }
  void pull(int i) {
    int64_t a = mn[2 * i], b = mn[2 * i + 1];
    if (a < b) { mn[i] = a; cnt[i] = cnt[2 * i]; }
    else if (b < a) { mn[i] = b; cnt[i] = cnt[2 * i + 1]; }
    else { mn[i] = a; cnt[i] = cnt[2 * i] + cnt[2 * i + 1]; }
  }
  void add_one(int pos) {
    int i = n + pos;
    mn[i] += 1;
    for (i >>= 1; i >= 1; i >>= 1) pull(i);
  }
  // (min, count) over [lo, hi] inclusive
  void query(int node, int nl, int nr, int lo, int hi, int64_t& m,
             int64_t& c) const {
    if (hi < nl || nr < lo) return;
    if (lo <= nl && nr <= hi) {
      if (mn[node] < m) { m = mn[node]; c = cnt[node]; }
      else if (mn[node] == m) c += cnt[node];
      return;
    }
    int mid = (nl + nr) / 2;
    query(2 * node, nl, mid, lo, hi, m, c);
    query(2 * node + 1, mid + 1, nr, lo, hi, m, c);
  }
  // position of the k-th (0-based) occurrence of value m in [lo, hi].
  // NOTE: prune on mn[node] > m, not != m — a partially-covered node's
  // subtree min can come from an out-of-range leaf smaller than the
  // range-restricted min m, and such nodes may still hold occurrences.
  int kth(int node, int nl, int nr, int lo, int hi, int64_t m,
          int64_t& k) const {
    if (hi < nl || nr < lo || mn[node] > m) return -1;
    if (nl == nr) {
      if (mn[node] != m) return -1;
      if (k == 0) return nl;
      k -= 1;
      return -1;
    }
    if (lo <= nl && nr <= hi) {
      // fully covered: subtree ⊆ [lo,hi] ⇒ its min ≥ m; with the prune
      // above, mn[node] == m exactly here unless no occurrence exists.
      if (mn[node] != m) return -1;
      if (k >= cnt[node]) {
        k -= cnt[node];  // all occurrences here are before the k-th
        return -1;
      }
      // k-th occurrence lies in this subtree: descend by counts
      int cur = node, cl = nl, cr = nr;
      while (cl != cr) {
        int mid = (cl + cr) / 2;
        int l = 2 * cur, r = 2 * cur + 1;
        int64_t lc = (mn[l] == m) ? cnt[l] : 0;
        if (k < lc) { cur = l; cr = mid; }
        else { k -= lc; cur = r; cl = mid + 1; }
      }
      return cl;
    }
    int mid = (nl + nr) / 2;
    int res = kth(2 * node, nl, mid, lo, hi, m, k);
    if (res >= 0) return res;
    return kth(2 * node + 1, mid + 1, nr, lo, hi, m, k);
  }
};

// index_of: exact linear-scan rule (core/bvec.py _index_of).
static void index_of(const int64_t* bb, int nb, int64_t length, int& low,
                     int& high) {
  low = nb - 1;
  high = 0;
  for (int i = 0; i < nb; i++) {
    int64_t prev = i > 0 ? bb[i - 1] : 0;
    int prev_index = i > 0 ? i - 1 : 0;
    if (prev <= length && length <= bb[i]) {
      if (prev_index < low) low = prev_index;
      if (prev_index > high) high = prev_index;
    }
  }
  if (length >= bb[nb - 1] && nb - 1 > high) high = nb - 1;
}

}  // namespace

extern "C" void mc_bvec_targets(const int64_t* lengths, int64_t n,
                                const int64_t* bounds, int64_t nb,
                                int32_t* out) {
  SegTree st(static_cast<int>(nb));
  std::unordered_map<int64_t, std::pair<int, int>> memo;
  memo.reserve(1024);
  for (int64_t p = 0; p < n; p++) {
    int64_t L = lengths[p];
    auto it = memo.find(L);
    int front, back;
    if (it == memo.end()) {
      index_of(bounds, static_cast<int>(nb), L, front, back);
      memo.emplace(L, std::make_pair(front, back));
    } else {
      front = it->second.first;
      back = it->second.second;
    }
    int64_t m = INT64_MAX, c = 0;
    st.query(1, 0, st.n - 1, front, back, m, c);
    int64_t k = c / 2;  // middle of the minimal bins
    int target = st.kth(1, 0, st.n - 1, front, back, m, k);
    out[p] = target;
    st.add_one(target);
  }
}
