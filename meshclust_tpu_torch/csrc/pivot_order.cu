// Training's pivot orders for Hopper (sm_90a): one kernel orders every point
// by its distance key to a pivot, exactly as libstdc++'s std::sort leaves
// them, one block a pivot's row and every row of a launch at once.
//
// Replaces no TPU kernel: the JAX package builds these orders on the host
// (meshclust_tpu/core/trainer.py:157-193, Trainer._ref_order_chain: the
// exact Manhattan rows, the keys in float64, then native/refsort.cpp's
// std::sort a row). The port ran the same chain (ops/pivot_order.py's plain
// version), with the card idle through its float64 key arithmetic and its
// serial sorts. A block
//   1. computes its pivot p's key to every point j from the histogram rows
//      in their storage dtype, DivergencePoint::distance
//      (DivergencePoint.cpp:68-81) as the plain version has it:
//        man  = sum_v |h[p, v] - h[j, v]|   (exact integers)
//        frac = (msum - man) / msum,  msum = mag[p] + mag[j]  (double)
//        key  = (uint64) (10000 * fma(-frac, frac, 1))
//      each operation an explicit round-to-nearest intrinsic: the reference
//      is built with -ffp-contract=fast, so its 1 - frac^2 is one fused
//      rounding, and the fma is written out so that nvcc's own contraction
//      does not decide it. Keys are at most 10,000: 16 bits a point;
//   2. orders the launch's input permutation by key[idx] as std::sort does
//      (GCC 12, bits/stl_algo.h:1838-1940; the order of tied keys is the
//      algorithm's, and the sampled training pairs depend on it):
//      __introsort_loop to ranges of at most kThreshold (16) elements, a
//      depth limit of 2 floor(log2 n) with each child range at its parent's
//      less one, __move_median_to_first's exact comparisons, and
//      __partial_sort(first, last, last) (__make_heap, __sort_heap by
//      libstdc++'s __adjust_heap, one thread) for a range whose depth is
//      spent. Its sequential steps are computed in parallel:
//      - __unguarded_partition(first + 1, last, first) with pivot value pv
//        swaps the j-th position of [f + 1, l) with key >= pv (ascending,
//        L_j) and the j-th position of [f, l) with key <= pv (descending,
//        R_j) for the prefix of pairs with L_j < R_j. So a position decides
//        from two prefix counts whether it moves: an L at rank j moves iff
//        at least j + 1 R lie right of it, an R at rank j (from the right)
//        iff at least j + 1 L lie left of it; the s moving L write their
//        positions to scr[f + j], the moving R to scr[l - 1 - j], and the s
//        pairs swap. The cut (the scan's stop) is the least of the first L
//        that stays and the moving R;
//      - each partition leaves every key left of the cut <= pv <= every key
//        right of it, and __final_insertion_sort moves an element only past
//        a strictly greater key, so it is a stable insertion sort inside
//        each leaf range (<= 16 elements; a heap-sorted range is already in
//        order), every leaf at once.
//      A round takes every pending range: those past kLarge elements one at
//      a time by the whole block (its prefix counts a block scan over a
//      contiguous chunk a thread), the others by warps (a warp a range,
//      ballots over 32 positions at a time); children go to the next
//      round's list;
//   3. writes the order to its row of `out`.
//
// Placement: the row's workspace (indices, the swap slots, the keys, the
// leaf bits and two range lists, about 11.5 bytes a point) lives in
// dynamic shared memory when it fits (n up to ~20,000: the 15k-read
// corpora), else in global scratch that the wrapper allocates, a row's
// slice a block (the 150k-read deployment); the code is the same.
//
// Bound: by bytes, each block reads the histogram's rows once (V bytes a
// row at int8 counts) and writes n 4-byte indices: 151 rows of 15,000 x 256
// B are 580 MB from L2, 3.8 MB of it from HBM, and 9 MB of orders out, a
// few us; by operations, ~580M integer abs-adds and ~32M compares, also
// tiny. So the kernel is latency-bound by its ~26 partition levels a row;
// the design keeps every level inside the block, with no launch between
// them, and gives the small ranges of the lower levels to warps at once.
#include "common.cuh"

namespace {

constexpr int kPoThreads = 512;
constexpr int kPoWarps = kPoThreads / 32;
// libstdc++'s _S_threshold: ranges of at most this many elements are left
// to the final insertion sort.
constexpr int kThreshold = 16;
// Ranges past this many elements are partitioned by the whole block.
constexpr int kLarge = 2048;
// Points a group of lanes keys at once.
constexpr int kKeyUnroll = 4;
// Static shared memory beside the dynamic workspace.
constexpr int kReserve = 1024;

struct Range {
  int f, l, d;
};

struct Work {
  int* idx;           // the order being built, n
  int* scr;           // a partition's swap slots, n
  uint16_t* key;      // the keys by point, n
  unsigned* bits;     // a leaf starts at each set bit
  Range* list[2];     // this round's ranges and the next's
};

__host__ __device__ inline i64 align16(i64 b) { return (b + 15) & ~i64(15); }

// Pending ranges are disjoint and longer than kThreshold.
__host__ __device__ inline i64 list_cap(i64 n) {
  return n / (kThreshold + 1) + 1;
}

__host__ __device__ inline i64 bit_words(i64 n) { return (n + 31) / 32; }

// The workspace's bytes for n points, each part 16-byte aligned.
__host__ __device__ inline i64 ws_bytes(i64 n) {
  return 2 * align16(4 * n) + align16(2 * n) + align16(4 * bit_words(n)) +
         2 * align16(static_cast<i64>(sizeof(Range)) * list_cap(n));
}

__device__ Work carve(char* base, int n) {
  Work w;
  w.idx = reinterpret_cast<int*>(base);
  base += align16(4 * i64(n));
  w.scr = reinterpret_cast<int*>(base);
  base += align16(4 * i64(n));
  w.key = reinterpret_cast<uint16_t*>(base);
  base += align16(2 * i64(n));
  w.bits = reinterpret_cast<unsigned*>(base);
  base += align16(4 * bit_words(n));
  w.list[0] = reinterpret_cast<Range*>(base);
  base += align16(i64(sizeof(Range)) * list_cap(n));
  w.list[1] = reinterpret_cast<Range*>(base);
  return w;
}

// DivergencePoint::distance from the exact Manhattan sum and the two mags.
__device__ __forceinline__ uint16_t distance_key(i64 man, i64 mag_sum) {
  const double msum = __ll2double_rn(mag_sum);
  const double frac = __ddiv_rn(__dsub_rn(msum, __ll2double_rn(man)), msum);
  return static_cast<uint16_t>(
      __double2ull_rz(__dmul_rn(10000.0, __fma_rn(-frac, frac, 1.0))));
}

// key[j] for every point j: a group of `lanes` lanes a point (the least
// power of two that covers its nv pieces, at most 32), kKeyUnroll points a
// group at a time, the pivot's row through L1.
template <typename T, int VEC>
__device__ void row_keys(const char* __restrict__ hist, i64 pitch, int nv,
                         int lanes, const i64* __restrict__ mag, i64 p, int n,
                         uint16_t* key) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = 32 / lanes, g = lane / lanes, gl = lane % lanes;
  const int step = kPoWarps * groups;
  const char* prow = hist + p * pitch;
  const i64 mp = mag[p];
  for (int j0 = warp * groups; j0 < n; j0 += step * kKeyUnroll) {
    i64 man[kKeyUnroll];
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const int j = j0 + u * step + g;
      typename Acc<T>::type m = 0, dot = 0;
      if (j < n) {
        const char* jrow = hist + static_cast<i64>(j) * pitch;
        for (int q = gl; q < nv; q += lanes)
          add_piece<T, VEC>(load_center<VEC>(prow + q * VEC),
                            load_row<VEC>(jrow + q * VEC), m, dot);
      }
      man[u] = m;
    }
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const i64 sum = group_sum(man[u], lanes);
      const int j = j0 + u * step + g;
      if (j < n && gl == 0) key[j] = distance_key(sum, mp + mag[j]);
    }
  }
}

__device__ __forceinline__ void swap_idx(int* idx, int a, int b) {
  const int t = idx[a];
  idx[a] = idx[b];
  idx[b] = t;
}

// __move_median_to_first(result, a, b, c): the same comparisons.
__device__ void median_to_first(const Work& w, int result, int a, int b,
                                int c) {
  const int ka = w.key[w.idx[a]], kb = w.key[w.idx[b]], kc = w.key[w.idx[c]];
  int pick;
  if (ka < kb)
    pick = kb < kc ? b : ka < kc ? c : a;
  else
    pick = ka < kc ? a : kb < kc ? c : b;
  swap_idx(w.idx, result, pick);
}

// __adjust_heap then __push_heap over a[0, len), as libstdc++ 12.
__device__ void adjust_heap(int* a, const uint16_t* key, int hole, int len,
                            int value) {
  const int top = hole;
  int child = hole;
  while (child < (len - 1) / 2) {
    child = 2 * (child + 1);
    if (key[a[child]] < key[a[child - 1]]) child--;
    a[hole] = a[child];
    hole = child;
  }
  if ((len & 1) == 0 && child == (len - 2) / 2) {
    child = 2 * (child + 1);
    a[hole] = a[child - 1];
    hole = child - 1;
  }
  const int kv = key[value];
  int parent = (hole - 1) / 2;
  while (hole > top && key[a[parent]] < kv) {
    a[hole] = a[parent];
    hole = parent;
    parent = (hole - 1) / 2;
  }
  a[hole] = value;
}

// __partial_sort(first, last, last) on [f, l): __make_heap, __sort_heap.
// Every position of the range then starts a leaf of its own.
__device__ void heap_sort(const Work& w, int f, int l) {
  int* a = w.idx + f;
  const int len = l - f;
  for (int parent = (len - 2) / 2; len >= 2; --parent) {
    adjust_heap(a, w.key, parent, len, a[parent]);
    if (parent == 0) break;
  }
  for (int last = len - 1; last > 0; --last) {
    const int v = a[last];
    a[last] = a[0];
    adjust_heap(a, w.key, 0, last, v);
  }
  for (int p = f; p < l; ++p) atomicOr(&w.bits[p >> 5], 1u << (p & 31));
}

// A child range: to the next round's list, or a leaf.
__device__ void push(const Work& w, Range* next, int* count, int f, int l,
                     int d) {
  if (l - f > kThreshold)
    next[atomicAdd(count, 1)] = Range{f, l, d};
  else
    atomicOr(&w.bits[f >> 5], 1u << (f & 31));
}

// The exclusive prefix sum of v over the block, and its total.
__device__ u64 block_exclusive_scan(u64 v, u64* total) {
  __shared__ u64 warp_sums[kPoWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  u64 base = 0, all = 0;
#pragma unroll
  for (int i = 0; i < kPoWarps; ++i) {
    const u64 s = warp_sums[i];
    base += i < warp ? s : 0;
    all += s;
  }
  *total = all;
  __syncthreads();                  // warp_sums is the next scan's
  return base + x - v;
}

struct Part {
  int pv, s, cut;
};

// One partition of r by the whole block (every thread calls it).
__device__ void block_step(const Work& w, Range r, Range* next, int* count,
                           int* heaps, Part& sh) {
  const int t = threadIdx.x, f = r.f, l = r.l;
  if (r.d == 0) {
    if (t == 0) {
      heap_sort(w, f, l);
      atomicAdd(heaps, 1);
    }
    __syncthreads();
    return;
  }
  if (t == 0) {
    median_to_first(w, f, f + 1, f + (l - f) / 2, l - 1);
    sh.pv = w.key[w.idx[f]];
    sh.s = 0;
    sh.cut = l;
  }
  __syncthreads();
  const int pv = sh.pv;
  // a contiguous chunk a thread, of an odd length (no bank conflicts)
  const int chunk = ((l - f + kPoThreads - 1) / kPoThreads) | 1;
  const int a = min(f + t * chunk, l), b = min(a + chunk, l);
  int cL = 0, cR = 0;
  for (int p = a; p < b; ++p) {
    const int k = w.key[w.idx[p]];
    cL += p > f && k >= pv;
    cR += k <= pv;
  }
  u64 total;
  const u64 pre = block_exclusive_scan(
      static_cast<u64>(cL) << 32 | static_cast<u64>(cR), &total);
  int preL = static_cast<int>(pre >> 32), preR = static_cast<int>(pre);
  const int totR = static_cast<int>(total);
  int moved = 0, cut = l;
  for (int p = a; p < b; ++p) {
    const int k = w.key[w.idx[p]];
    const bool isL = p > f && k >= pv, isR = k <= pv;
    const int after = totR - preR - isR;    // R right of p: its rank
    const bool mvL = isL && after >= preL + 1, mvR = isR && preL >= after + 1;
    if (mvL) w.scr[f + preL] = p;
    if (mvR) w.scr[l - 1 - after] = p;
    if ((isL && !mvL) || mvR) cut = min(cut, p);
    moved += mvL;
    preL += isL;
    preR += isR;
  }
  if (moved) atomicAdd(&sh.s, moved);
  if (cut < l) atomicMin(&sh.cut, cut);
  __syncthreads();
  const int s = sh.s;
  for (int j = t; j < s; j += kPoThreads)
    swap_idx(w.idx, w.scr[f + j], w.scr[l - 1 - j]);
  __syncthreads();
  if (t == 0) {
    push(w, next, count, f, sh.cut, r.d - 1);
    push(w, next, count, sh.cut, l, r.d - 1);
  }
}

// One partition of r by one warp (every lane calls it).
__device__ void warp_step(const Work& w, Range r, Range* next, int* count,
                          int* heaps) {
  const int lane = threadIdx.x & 31, f = r.f, l = r.l;
  if (r.d == 0) {
    if (lane == 0) {
      heap_sort(w, f, l);
      atomicAdd(heaps, 1);
    }
    __syncwarp();
    return;
  }
  if (lane == 0) median_to_first(w, f, f + 1, f + (l - f) / 2, l - 1);
  __syncwarp();
  const int pv = w.key[w.idx[f]];
  int totR = 0;
  for (int base = f; base < l; base += 32) {
    const int p = base + lane;
    totR += __popc(__ballot_sync(0xffffffffu, p < l && w.key[w.idx[p]] <= pv));
  }
  const unsigned below = (1u << lane) - 1;
  int preL = 0, preR = 0, s = 0, cut = l;
  for (int base = f; base < l; base += 32) {
    const int p = base + lane;
    const int k = p < l ? w.key[w.idx[p]] : 0;
    const bool isL = p < l && p > f && k >= pv, isR = p < l && k <= pv;
    const unsigned bl = __ballot_sync(0xffffffffu, isL),
                   br = __ballot_sync(0xffffffffu, isR);
    const int myL = preL + __popc(bl & below);
    const int after = totR - (preR + __popc(br & below)) - isR;
    const bool mvL = isL && after >= myL + 1, mvR = isR && myL >= after + 1;
    if (mvL) w.scr[f + myL] = p;
    if (mvR) w.scr[l - 1 - after] = p;
    if ((isL && !mvL) || mvR) cut = min(cut, p);
    s += __popc(__ballot_sync(0xffffffffu, mvL));
    preL += __popc(bl);
    preR += __popc(br);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    cut = min(cut, __shfl_xor_sync(0xffffffffu, cut, o));
  __syncwarp();
  for (int j = lane; j < s; j += 32)
    swap_idx(w.idx, w.scr[f + j], w.scr[l - 1 - j]);
  __syncwarp();
  if (lane == 0) {
    push(w, next, count, f, cut, r.d - 1);
    push(w, next, count, cut, l, r.d - 1);
  }
}

// Stable insertion sort of the leaf [p, e).
__device__ void sort_leaf(const Work& w, int p, int e) {
  for (int i = p + 1; i < e; ++i) {
    const int v = w.idx[i], kv = w.key[v];
    int j = i;
    for (; j > p && w.key[w.idx[j - 1]] > kv; --j) w.idx[j] = w.idx[j - 1];
    w.idx[j] = v;
  }
}

__device__ __forceinline__ bool leaf_starts(const Work& w, int p) {
  return (w.bits[p >> 5] >> (p & 31)) & 1u;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kPoThreads)
pivot_order_kernel(const char* __restrict__ hist, i64 pitch, int nv,
                   int lanes, const i64* __restrict__ mag,
                   const i64* __restrict__ rows, const int* __restrict__ perm,
                   int n, int* __restrict__ out, char* ws, i64 ws_row,
                   int* heap_count) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int count[2];
  __shared__ int heaps;
  __shared__ Part sh;
  const int t = threadIdx.x, warp = t >> 5;
  const Work w = carve(ws ? ws + blockIdx.x * ws_row : smem, n);
  row_keys<T, VEC>(hist, pitch, nv, lanes, mag, rows[blockIdx.x], n, w.key);
  for (int i = t; i < n; i += kPoThreads) w.idx[i] = perm[i];
  for (int i = t; i < bit_words(n); i += kPoThreads) w.bits[i] = 0u;
  if (t == 0) {
    heaps = 0;
    count[0] = 0;
    count[1] = 0;
  }
  __syncthreads();
  if (t == 0) {
    // __sort: __lg(n) * 2 levels
    if (n > kThreshold)
      w.list[0][count[0]++] = Range{0, n, 2 * (31 - __clz(n))};
    else if (n > 0)
      w.bits[0] = 1u;
  }
  __syncthreads();
  for (int cur = 0; count[cur] > 0; cur ^= 1) {
    const int m = count[cur];
    const Range* in = w.list[cur];
    Range* next = w.list[cur ^ 1];
    for (int i = 0; i < m; ++i) {
      const Range r = in[i];
      if (r.l - r.f > kLarge) block_step(w, r, next, &count[cur ^ 1], &heaps,
                                         sh);
    }
    for (int i = warp; i < m; i += kPoWarps) {
      const Range r = in[i];
      if (r.l - r.f <= kLarge) warp_step(w, r, next, &count[cur ^ 1], &heaps);
    }
    __syncthreads();
    if (t == 0) count[cur] = 0;
    __syncthreads();
  }
  for (int p = t; p < n; p += kPoThreads) {
    if (!leaf_starts(w, p)) continue;
    int e = p + 1;
    while (e < n && !leaf_starts(w, e)) ++e;
    sort_leaf(w, p, e);
  }
  __syncthreads();
  int* row = out + static_cast<i64>(blockIdx.x) * n;
  for (int i = t; i < n; i += kPoThreads) row[i] = w.idx[i];
  if (t == 0 && heaps) atomicAdd(heap_count, heaps);
}

bool fits_shared(i64 n) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return ws_bytes(n) + kReserve <= optin;
}

template <typename T, int VEC>
int launch_orders(cudaStream_t s, const void* hist, i64 pitch, i64 length,
                  const void* mag, const void* rows, int P, const void* perm,
                  int n, void* out, void* ws, void* heaps) {
  const int nv = static_cast<int>(length / VEC);
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  const i64 bytes = ws_bytes(n);
  if (!ws && !fits_shared(n)) return cudaErrorInvalidValue;
  const i64 smem = ws ? 0 : bytes;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(pivot_order_kernel<T, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  pivot_order_kernel<T, VEC><<<P, kPoThreads, smem, s>>>(
      static_cast<const char*>(hist), pitch, nv, lanes,
      static_cast<const i64*>(mag), static_cast<const i64*>(rows),
      static_cast<const int*>(perm), n, static_cast<int*>(out),
      static_cast<char*>(ws), bytes, static_cast<int*>(heaps));
  return cudaGetLastError();
}

}  // namespace

// -- host side --------------------------------------------------------------

// Bytes of global scratch a row needs at n points: 0 where the workspace
// fits the block's shared memory.
extern "C" int mc_pivot_order_scratch(int n) {
  return fits_shared(n) ? 0 : static_cast<int>(ws_bytes(n));
}

// out[r] = perm ordered by the keys of pivot rows[r] as std::sort would,
// for r < P; heaps += the ranges that took the heap path. ws: null, or
// P x mc_pivot_order_scratch(n) bytes.
extern "C" int mc_pivot_order(const void* hist, long long stride, int V,
                              int width, const void* mag, const void* rows,
                              int P, const void* perm, int n, void* out,
                              void* ws, void* heaps, void* stream) {
  if (P <= 0 || n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 pitch = stride * width, length = static_cast<i64>(V) * width;
  const int vec = piece_bytes(hist, pitch, length, width);
#define MC_ORDERS(T, VEC)                                                \
  case VEC:                                                              \
    return launch_orders<T, VEC>(s, hist, pitch, length, mag, rows, P,  \
                                 perm, n, out, ws, heaps)
  MC_ROW_CASES(MC_ORDERS);
#undef MC_ORDERS
}
