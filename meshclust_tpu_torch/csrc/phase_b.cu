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
//             FMA), d kept in dstore [2 delta + 1, M] (offset-major),
//             and the least d of each center (best_d);
//   pb_pick   for each positive whose d is its center's least: the least
//             pool position (best_pos); and the rows of sc that pb_band
//             touched zeroed for the next band;
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
// chains' ends are each chain followed to the center whose target is
// itself, which the plain steps' ceil(log2 C) jumps also reach; the kept
// centers' new slots are an exclusive scan of integer counts.
//
// Bound: bytes, and for pb_band the integer operations of man and dot as
// much. An iteration must read the members' rows twice (the band's
// classifier, the distances), each center's row (L2-resident: C rows), the
// members' assign, bits and, for the positives, dstore, and write sc. At 1M
// reads (V = 256 int8 counts, 12k centers) that is ~2 x 256 MB: ~0.15 ms
// at 3.35 TB/s; the plain steps built [M, V] int64 temporaries at every
// offset (2 GB at 1M). The design: pb_band and pb_dist take a tile of 32
// members a block and stage its member rows once in shared memory
// (cp.async), and the tile's span of centers (pb_band: their rows; pb_dist:
// their floored means, divided once a tile); then one thread a (member,
// offset) pair reads both rows from shared memory (byte SIMD for int8, no
// shuffle) and runs the classifier on its own pair, with the terms of one
// side alone computed once a row (common.cuh:row_terms); a center's
// positives in the tile are a 32-bit mask, so the tile adds a center's
// rows once, an atomic a column, whatever the offsets. A tile whose span
// of centers does not fit the stage (after merges assign is not monotone)
// reads the centers through L1 in the same kernel. pb_merge stages a
// tile's slots (moves, rows) once, scans the kept centers across its
// blocks by a single-pass look-back and compacts them in place; its last
// block follows only the chains that leave a block, with no host round
// trip.
#include "common.cuh"

namespace {

// pb_band's and pb_dist's tile: kTile members, a lane each (and a bit each
// in a center's 32-bit mask), so that 15k members make 469 tiles, past two
// blocks an SM on 132 SMs; a block of kTileThreads, a warp an offset of the
// tile's members at a time.
constexpr int kTile = 32;
constexpr int kTileThreads = 128;
constexpr int kTileWarps = kTileThreads / 32;
// The blocks of pb_band and of pb_dist an SM must hold at once (their
// registers' limit, 64 and 51 a thread): a tile's phases wait on memory
// and barriers, so the tiles in flight set the time (profile_port.py
// pbvariants times both against kBandBlocks=1 and kDistBlocks=1).
constexpr int kBandBlocks = 8;
constexpr int kDistBlocks = 10;
static_assert(kTile == 32, "a lane a member, a bit a member in a mask");
// A tile stages its members' rows, and the rows of its span of centers
// (pb_band) or their floored means (pb_dist), in shared memory: at most
// kSpanRows center rows, and at most kStageBytes of rows in all. A tile
// whose span is longer takes the kernel's global path (centers read
// through L1, sums added a positive at a time).
constexpr int kStageBytes = 49152;
constexpr int kSpanRows = 32;
// State.paths: the tiles pb_band and pb_dist ran on each path.
constexpr int kBandStaged = 0, kBandGlobal = 1, kDistStaged = 2,
              kDistGlobal = 3;
// The pieces a thread sums in 32 bits before it widens (int8: 2^23 at most).
constexpr int kChunkPieces = 32;
// The columns of a center's sums a lane of pb_dist loads before it divides.
constexpr int kMeanLoads = 8;
// Slots of pb_merge's scratch (ops/phase_b.py: scratch_len): the last
// block's ticket, the tiles' ticket and the count of listed chains, then
// NP (the kept centers' new slots), the list of merged centers whose chain
// leaves their tile, and a look-back descriptor a tile, C int64 each; all
// zero between launches but NP and the list.
constexpr int kTicket = 0, kTiles = 1, kMerged = 2, kScratchHead = 3;
// DBL_MIN, the floor of the merge's best f1 (Trainer.cpp:132-135).
constexpr double kDblMin = 2.2250738585072014e-308;

__host__ __device__ __forceinline__ i64 round16(i64 x) {
  return (x + 15) & ~static_cast<i64>(15);
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

// The classifier's packed arrays (ops/classifier.py:Model) into shared memory.
__device__ void stage_model(double* model, const int* spec_g, int n_spec,
                            const double* coef_g, int n_coef) {
  int* spec = reinterpret_cast<int*>(model + n_coef);
  for (int i = threadIdx.x; i < n_coef; i += blockDim.x) model[i] = coef_g[i];
  for (int i = threadIdx.x; i < n_spec; i += blockDim.x) spec[i] = spec_g[i];
}

// ---------------------------------------------------------------------------
// Staging a tile's rows, and a thread's sums over a pair of rows
// ---------------------------------------------------------------------------

// 16 bytes from device to shared memory without a register (cp.async; L2
// only: each row is read once a tile).
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int VEC>
__device__ __forceinline__ void store_piece(char* p, const Piece<VEC>& v) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < Piece<VEC>::kWords; ++i)
      reinterpret_cast<uint32_t*>(p)[i] = v.w[i];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(v.w[0]);
  } else {
    *p = static_cast<char>(v.w[0]);
  }
}

// Rows src(r), r < n (length bytes each, VEC dividing it), into shared
// memory at dst + r * spitch, zero past length up to a whole 16-byte
// piece; a thread a piece at a time, 16-byte pieces by cp.async (the
// caller waits: copies_done, then a barrier). src(r) null: not copied.
template <int VEC, class Src>
__device__ void stage_rows(char* dst, int spitch, int n, int length,
                           Src src) {
  const int pieces = length / VEC;
  for (int i = threadIdx.x; i < n * pieces; i += blockDim.x) {
    const int r = i / pieces, p = i - r * pieces;
    const char* s = src(r);
    if (s == nullptr) continue;
    char* d = dst + r * spitch + p * VEC;
    if constexpr (VEC == 16)
      copy16_async(d, s + p * 16);
    else
      store_piece<VEC>(d, load_row<VEC>(s + p * VEC));
  }
  const int pad = static_cast<int>(round16(length)) - length;
  for (int i = threadIdx.x; i < n * pad; i += blockDim.x) {
    const int r = i / pad;
    if (src(r) != nullptr) dst[r * spitch + length + (i - r * pad)] = 0;
  }
}

// One row (length bytes, VEC dividing it) into shared memory at dst by
// one thread, zero past length up to a whole 16-byte piece.
template <int VEC>
__device__ void stage_row(char* dst, const char* src, int length) {
  for (int p = 0; p < length; p += VEC) {
    if constexpr (VEC == 16)
      copy16_async(dst + p, src + p);
    else
      store_piece<VEC>(dst + p, load_row<VEC>(src + p));
  }
  for (int b = length; b < round16(length); ++b) dst[b] = 0;
}

// man += sum |a - b| and dot += sum a * b over one 16-byte piece of
// staged rows: int8 by the signed-byte form of vabsdiff4 (add_piece biases
// both sides to unsigned for __vsadu4, two more operations a word) and
// __dp4a, exact in 32 bits; wider counts as add_piece.
template <typename T>
__device__ __forceinline__ void add_staged(const Piece<16>& a,
                                           const Piece<16>& b,
                                           typename Acc<T>::type& man,
                                           typename Acc<T>::type& dot) {
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      asm("vabsdiff4.u32.s32.s32.add %0, %1, %2, %0;"
          : "+r"(man)
          : "r"(a.w[i]), "r"(b.w[i]));
      dot = __dp4a(static_cast<int>(a.w[i]), static_cast<int>(b.w[i]), dot);
    }
  } else {
    add_piece<T, 16>(a, b, man, dot);
  }
}

// man and dot of two rows staged in shared memory (np 16-byte pieces, zero
// past the rows' end), a thread a pair: Acc<T> sums over kChunkPieces
// pieces, 64 bits across them.
template <typename T>
__device__ __forceinline__ void staged_sums(const char* a, const char* b,
                                            int np, i64& man, i64& dot) {
  typedef typename Acc<T>::type A;
  man = 0;
  dot = 0;
  for (int p0 = 0; p0 < np; p0 += kChunkPieces) {
    const int p1 = np < p0 + kChunkPieces ? np : p0 + kChunkPieces;
    A m = 0, d = 0;
#pragma unroll 4
    for (int p = p0; p < p1; ++p)
      add_staged<T>(load_shared<16>(a + p * 16), load_shared<16>(b + p * 16),
                    m, d);
    man += m;
    dot += d;
  }
}

// The same with a's row in device memory (through L1: a tile's members
// meet a center at several offsets) and b's in shared or device memory
// (a generic load), in nv pieces of VEC bytes.
template <typename T, int VEC>
__device__ __forceinline__ void global_sums(const char* a, const char* b,
                                            int nv, i64& man, i64& dot) {
  typedef typename Acc<T>::type A;
  man = 0;
  dot = 0;
  for (int p0 = 0; p0 < nv; p0 += kChunkPieces) {
    const int p1 = nv < p0 + kChunkPieces ? nv : p0 + kChunkPieces;
    A m = 0, d = 0;
    for (int p = p0; p < p1; ++p)
      add_piece<T, VEC>(load_center<VEC>(a + static_cast<i64>(p) * VEC),
                        load_shared<VEC>(b + static_cast<i64>(p) * VEC), m,
                        d);
    man += m;
    dot += d;
  }
}

// sum min(a, b) of a member's row and a floored mean, both staged.
template <typename T>
__device__ __forceinline__ i64 staged_min_sum(const char* a, const char* b,
                                              int np) {
  typedef typename Acc<T>::type A;
  i64 s = 0;
  for (int p0 = 0; p0 < np; p0 += kChunkPieces) {
    const int p1 = np < p0 + kChunkPieces ? np : p0 + kChunkPieces;
    A acc = 0;
#pragma unroll 4
    for (int p = p0; p < p1; ++p)
      add_min<T, 16>(load_shared<16>(a + p * 16), load_shared<16>(b + p * 16),
                     acc);
    s += acc;
  }
  return s;
}

// A column sum of up to kTile counts: 32 bits for int8 and int16 counts
// (kTile x 32767 fits), 64 otherwise (wrapping as torch's int64 sums).
template <typename T>
struct ColSum {
  typedef i64 type;
};
template <>
struct ColSum<int8_t> {
  typedef int type;
};
template <>
struct ColSum<int16_t> {
  typedef int type;
};

// Columns v0 .. v0 + 3 (those below V) of the staged rows of the members
// in mask, summed and added into out (int64 atomics, none for a zero).
template <typename T>
__device__ __forceinline__ void add_columns(const char* mrow, int spitch,
                                            unsigned mask, int v0, int V,
                                            i64* out) {
  typename ColSum<T>::type acc[4] = {0, 0, 0, 0};
  for (unsigned mm = mask; mm; mm &= mm - 1) {
    const char* row = mrow + (__ffs(mm) - 1) * spitch;
    if constexpr (sizeof(T) == 1) {
      // 4 counts in one word: v0 is a multiple of 4, and the padded row
      // holds v0 + 3
      const unsigned x = *reinterpret_cast<const unsigned*>(row + v0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] += static_cast<int8_t>(x >> (8 * e));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (v0 + e < V) acc[e] += reinterpret_cast<const T*>(row)[v0 + e];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (v0 + e < V && acc[e])
      atomicAdd(reinterpret_cast<u64*>(out + v0 + e),
                static_cast<u64>(static_cast<i64>(acc[e])));
}

// Byte offsets of pb_band's and pb_dist's dynamic shared memory, laid out
// by the host (its size) and the kernel alike: the classifier's arrays
// (pb_band), the tile's member rows [kTile][spitch], then the span's
// center rows (pb_band) or floored means (pb_dist) [cap][spitch], then
// per tile member and per span row: RowTerms, the centers' point rows (-1:
// not valid) and masks of positive members (pb_band); sum cw, the least d
// and a flag of a positive (pb_dist).
struct TileSmem {
  i64 mrow, crow, mt, ct, cpt, cmask, cwt, least, cflag, bytes;
};

__host__ __device__ inline TileSmem tile_smem(i64 model, int spitch, int cap,
                                              bool band) {
  TileSmem s;
  i64 o = round16(model);
  s.mrow = o;
  o += static_cast<i64>(kTile) * spitch;
  s.crow = o;
  o += static_cast<i64>(cap) * spitch;
  s.mt = o;
  if (band) o += kTile * static_cast<i64>(sizeof(RowTerms));
  s.ct = o;
  if (band) o += cap * static_cast<i64>(sizeof(RowTerms));
  s.cpt = s.cwt = o;
  o += cap * 8;
  s.least = o;
  if (!band) o += cap * 8;
  s.cmask = s.cflag = o;
  o += cap * 4;
  s.bytes = o;
  return s;
}

// ---------------------------------------------------------------------------
// pb_band
// ---------------------------------------------------------------------------

// A block a tile of kTile members. Its first warp maps the tile's assign
// through remap (written back) and finds the tile's span of centers,
// [min assign - delta, max assign + delta] over its members that count;
// the grid resets best_d and best_pos. The tile's member rows go to shared
// memory once (cp.async), and, where the span holds at most `cap` rows,
// the span's center rows and the RowTerms of both sides (the staged path).
// Then a thread a (member, offset) pair, a warp an offset and a lane a
// member: man and dot over the whole row from shared memory (no shuffle),
// the float64 classifier, the bit into the member's word in shared memory,
// and on the staged path the member's bit into its center's mask. The
// bits are written a word at a time (32 offsets). Staged, each center of
// the span with a positive then adds, a column a thread, its members' rows
// and count into sc with one int64 atomic a column of the tile (none for a
// zero). On the global path (a span past cap, or rows too wide to stage)
// the centers are read through L1 and each positive adds its member's row
// into sc, an atomic a column.
template <typename T, int VEC>
__global__ void __launch_bounds__(kTileThreads, kBandBlocks)
pb_band_kernel(const char* __restrict__ rows, i64 pitch,
               const char* __restrict__ hist, i64 hpitch, int V, int length,
               const i64* __restrict__ m_idx,
               const uint8_t* __restrict__ m_valid, int M,
               i64* __restrict__ assign, const i64* __restrict__ remap,
               const i64* __restrict__ c_idx,
               const uint8_t* __restrict__ c_valid, int C,
               const double* __restrict__ mag, const double* __restrict__ sq,
               const double* __restrict__ lenf, const int* __restrict__ spec_g,
               int n_spec, const double* __restrict__ coef_g, int n_coef,
               int delta, int W, int spitch, int cap,
               unsigned* __restrict__ bits, i64* __restrict__ sc,
               double* __restrict__ best_d, i64* __restrict__ best_pos,
               i64 m_all, i64* __restrict__ paths) {
  extern __shared__ __align__(16) char smem[];
  __shared__ i64 asg[kTile];          // -1: no pair (past M, not m_valid)
  __shared__ unsigned word_s[kTile];  // the members' bits, a word at a time
  __shared__ int span_lo, span_hi;    // of the members' assign
  __shared__ int rlist[kSpanRows];
  __shared__ int n_rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = 2 * delta + 1;
  const i64 Vp = static_cast<i64>(V) + 1;
  const TileSmem L = tile_smem(
      n_coef * static_cast<i64>(sizeof(double)) + n_spec * 4, spitch, cap,
      true);
  double* model = reinterpret_cast<double*>(smem);
  char* mrow = smem + L.mrow;
  char* crow = smem + L.crow;
  RowTerms* mt = reinterpret_cast<RowTerms*>(smem + L.mt);
  RowTerms* ct = reinterpret_cast<RowTerms*>(smem + L.ct);
  i64* cpt = reinterpret_cast<i64*>(smem + L.cpt);
  unsigned* cmask = reinterpret_cast<unsigned*>(smem + L.cmask);
  stage_model(model, spec_g, n_spec, coef_g, n_coef);
  const double* coef = model;
  const int* spec = reinterpret_cast<const int*>(model + n_coef);
  for (i64 j = blockIdx.x * static_cast<i64>(kTileThreads) + tid; j < C;
       j += static_cast<i64>(gridDim.x) * kTileThreads) {
    best_d[j] = INFINITY;
    best_pos[j] = m_all;
  }
  for (int r = tid; r < cap; r += kTileThreads) cmask[r] = 0u;
  // the first warp, a lane a member, beside the model's loads: the remap,
  // the member's mag, sq and length, the span by warp reductions
  const i64 m0 = blockIdx.x * static_cast<i64>(kTile);
  double m_mag = 0.0, m_sq = 0.0, m_len = 0.0;
  if (warp == 0) {
    const i64 m = m0 + lane;
    i64 a = -1;
    if (m < M) {
      const i64 r = remap[assign[m]];
      assign[m] = r;
      if (m_valid == nullptr || m_valid[m]) {
        a = r;
        const i64 pt = m_idx[m];
        m_mag = mag[pt];
        m_sq = sq[pt];
        m_len = lenf[pt];
      }
    }
    asg[lane] = a;
    const int lo_a = __reduce_min_sync(
        0xffffffffu, a >= 0 ? static_cast<int>(a) : 0x7fffffff);
    const int hi_a = __reduce_max_sync(0xffffffffu, static_cast<int>(a));
    if (lane == 0) {
      span_lo = lo_a;
      span_hi = hi_a;
    }
  }
  __syncthreads();                    // the model, asg, the span

  const int flags = model_flags(spec);
  const double Vd = coef[0];
  if (warp == 0 && asg[lane] >= 0)
    mt[lane] = row_terms(flags, Vd, m_mag, m_sq, m_len);
  const i64 lo = span_lo - static_cast<i64>(delta) > 0
                     ? span_lo - static_cast<i64>(delta) : 0;
  const i64 hi = span_hi + static_cast<i64>(delta) < C - 1
                     ? span_hi + static_cast<i64>(delta) : C - 1;
  const int span = span_hi < 0 ? 0 : static_cast<int>(hi - lo + 1);
  const bool staged = spitch > 0 && span <= cap;
  if (spitch > 0)
    stage_rows<VEC>(mrow, spitch, kTile, length, [&](int t) -> const char* {
      return asg[t] >= 0 ? rows + (m0 + t) * pitch : nullptr;
    });
  if (staged) {
    // a thread a center of the span: its row's copies, then its terms
    for (int r = tid; r < span; r += kTileThreads) {
      const i64 j = lo + r;
      i64 pt = -1;
      if (c_valid[j]) {
        pt = c_idx[j];
        stage_row<VEC>(crow + r * spitch, hist + pt * hpitch, length);
        ct[r] = row_terms(flags, Vd, mag[pt], sq[pt], lenf[pt]);
      }
      cpt[r] = pt;
    }
  }
  copies_done();

  const int nv = length / VEC, np = static_cast<int>(round16(length) / 16);
  for (int w = 0; w * 32 < K; ++w) {
    if (tid < kTile) word_s[tid] = 0u;
    __syncthreads();                  // the rows (first word), word_s
    const int o1 = K < 32 * (w + 1) ? K : 32 * (w + 1);
    for (int oi = 32 * w + warp; oi < o1; oi += kTileWarps) {
      const int t = lane;
      const i64 a_m = asg[t];
      const i64 j = a_m + oi - delta;
      const bool ok = a_m >= 0 && j >= 0 && j < C;
      bool pos = false;
      double f1;
      if (staged) {
        const int r = static_cast<int>(j - lo);
        if (ok && cpt[r] >= 0) {
          i64 man, dot;
          staged_sums<T>(crow + r * spitch, mrow + t * spitch, np, man, dot);
          pos = classify_terms(spec, coef, flags, static_cast<double>(man),
                               static_cast<double>(dot), ct[r], mt[t], &f1);
          if (pos) atomicOr(cmask + r, 1u << t);
        }
      } else if (ok && c_valid[j]) {
        const i64 pt = c_idx[j];
        i64 man, dot;
        global_sums<T, VEC>(hist + pt * hpitch,
                            spitch > 0 ? mrow + t * spitch
                                       : rows + (m0 + t) * pitch,
                            nv, man, dot);
        pos = classify_terms(spec, coef, flags, static_cast<double>(man),
                             static_cast<double>(dot),
                             row_terms(flags, Vd, mag[pt], sq[pt], lenf[pt]),
                             mt[t], &f1);
      }
      if (pos) atomicOr(word_s + t, 1u << (oi & 31));
    }
    __syncthreads();                  // the word's bits
    if (tid < kTile && m0 + tid < M) bits[(m0 + tid) * W + w] = word_s[tid];
    if (!staged) {
      for (int t = warp; t < kTile; t += kTileWarps) {
        unsigned word = word_s[t];
        const char* row =
            spitch > 0 ? mrow + t * spitch : rows + (m0 + t) * pitch;
        while (word) {
          const int oi = 32 * w + __ffs(word) - 1;
          word &= word - 1;
          i64* out = sc + (asg[t] + oi - delta) * Vp;
          for (int v = lane; v <= V; v += 32) {
            const i64 x =
                v < V ? static_cast<i64>(reinterpret_cast<const T*>(row)[v])
                      : 1;
            if (x) atomicAdd(reinterpret_cast<u64*>(out + v),
                             static_cast<u64>(x));
          }
        }
      }
    }
    __syncthreads();                  // word_s read before the next word
  }

  if (staged) {
    if (warp == 0) {
      int n = 0;
      for (int r0 = 0; r0 < span; r0 += 32) {
        const int r = r0 + lane;
        const bool has = r < span && cmask[r] != 0u;
        const unsigned b = __ballot_sync(0xffffffffu, has);
        if (has) rlist[n + __popc(b & ((1u << lane) - 1u))] = r;
        n += __popc(b);
      }
      if (lane == 0) n_rows = n;
    }
    __syncthreads();
    // a thread 4 columns of a center (the last chunk: the count)
    const int chunks = (V + 3) / 4 + 1;
    for (int i = tid; i < n_rows * chunks; i += kTileThreads) {
      const int q = i / chunks, c = i - q * chunks;
      const int r = rlist[q];
      const unsigned mask = cmask[r];
      i64* out = sc + (lo + r) * Vp;
      if (c == chunks - 1)
        atomicAdd(reinterpret_cast<u64*>(out + V),
                  static_cast<u64>(__popc(mask)));
      else
        add_columns<T>(mrow, spitch, mask, 4 * c, V, out);
    }
  }
  if (tid == 0)
    atomicAdd(reinterpret_cast<u64*>(paths + (staged ? kBandStaged
                                                     : kBandGlobal)),
              1ull);
}

// ---------------------------------------------------------------------------
// pb_dist
// ---------------------------------------------------------------------------

// A block a tile of kTile members, pb_band's. Its first warp, a lane a
// member, reads the member's bits, counts its positives (a warp scan gives
// each member its first pair number) and finds the tile's span of
// centers with a positive. The rows of the members with a positive go to
// shared memory (cp.async). Where the span holds at most `cap` rows (the
// staged path), a warp a center of the span with a positive divides its
// floored mean cw = floor(sums / max(count, 1)) into shared memory in the
// rows' dtype (as common.cuh:tile_dist does) and sums cw; then a thread a
// positive pair (member and offset from the pair's number: the scan, then
// the member's bits) takes 2 sum min(h, cw) from shared memory (byte SIMD
// for int8), d = 10000 (1 - frac^2) in the plain chain, d into dstore
// (offset-major, [2 delta + 1, M]: pb_pick's warps read a row's doubles
// side by side) and into its center's least in shared memory (a 64-bit
// atomicMin on the bits of non-negative doubles); then one atomicMin a
// center into best_d.
// On the global path a positive divides its center's mean column by column
// itself and takes best_d's atomicMin directly.
template <typename T, int VEC>
__global__ void __launch_bounds__(kTileThreads, kDistBlocks)
pb_dist_kernel(const char* __restrict__ rows, i64 pitch, int V, int length,
               const i64* __restrict__ m_idx, int M,
               const i64* __restrict__ assign, const double* __restrict__ mag,
               int delta, int W, int spitch, int cap,
               const unsigned* __restrict__ bits, const i64* __restrict__ sc,
               double* __restrict__ dstore, double* __restrict__ best_d,
               i64* __restrict__ paths) {
  extern __shared__ __align__(16) char smem[];
  __shared__ i64 asg[kTile];          // -1: no positive
  __shared__ double mmag[kTile];
  __shared__ int first[kTile + 1];    // member t's pairs: first[t] .. [t + 1]
  __shared__ int span_lo, span_hi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const i64 Vp = static_cast<i64>(V) + 1;
  const TileSmem L = tile_smem(0, spitch, cap, false);
  char* mrow = smem + L.mrow;
  char* means = smem + L.crow;
  double* cwt = reinterpret_cast<double*>(smem + L.cwt);
  u64* least = reinterpret_cast<u64*>(smem + L.least);
  int* cflag = reinterpret_cast<int*>(smem + L.cflag);
  const i64 m0 = blockIdx.x * static_cast<i64>(kTile);
  // the first warp, a lane a member: its bits, their count and offsets,
  // the span by warp reductions, a scan for the pairs' numbers, and on
  // the staged path the flags of the span's centers with a positive
  double m_mag = 0.0;
  if (warp == 0) {
    for (int r = lane; r < cap; r += 32) {
      cflag[r] = 0;
      least[r] = ~0ull;
    }
    const i64 m = m0 + lane;
    int cnt = 0, j_lo = 0x7fffffff, j_hi = -1;
    i64 a = -1;
    if (m < M) {
      const i64 a_m = assign[m], pt = m_idx[m];  // beside the bits' loads
      int o_first = -1, o_last = -1;
      for (int w = 0; w < W; ++w) {
        const unsigned word = bits[m * W + w];
        if (word) {
          if (o_first < 0) o_first = 32 * w + __ffs(word) - 1;
          o_last = 32 * w + 31 - __clz(word);
          cnt += __popc(word);
        }
      }
      if (cnt) {
        a = a_m;
        m_mag = mag[pt];              // stored once the means are issued
        j_lo = static_cast<int>(a + o_first - delta);
        j_hi = static_cast<int>(a + o_last - delta);
      }
    }
    asg[lane] = a;
    int x = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += n;
    }
    first[lane + 1] = x;
    if (lane == 0) first[0] = 0;
    j_lo = __reduce_min_sync(0xffffffffu, j_lo);
    j_hi = __reduce_max_sync(0xffffffffu, j_hi);
    if (lane == 0) {
      span_lo = j_lo;
      span_hi = j_hi;
    }
    __syncwarp();                     // cflag zeroed
    if (spitch > 0 && j_hi >= 0 && j_hi - j_lo + 1 <= cap && cnt) {
      for (int w = 0; w < W; ++w) {
        unsigned word = bits[m * W + w];
        while (word) {
          cflag[a + 32 * w + __ffs(word) - 1 - delta - j_lo] = 1;
          word &= word - 1;
        }
      }
    }
  }
  __syncthreads();

  const int npos = first[kTile];
  const int lo = span_lo;
  const int span = span_hi < 0 ? 0 : span_hi - span_lo + 1;
  const bool staged = spitch > 0 && span <= cap;
  // pair i's member t and offset oi
  auto pair_of = [&](int i, int& t, int& oi) {
    t = 0;
#pragma unroll
    for (int s = kTile / 2; s; s >>= 1)
      if (first[t + s] <= i) t += s;
    int k = i - first[t];
    const unsigned* mb = bits + (m0 + t) * W;
    int w = 0;
    unsigned word = mb[0];
    for (int c = __popc(word); k >= c; c = __popc(word)) {
      k -= c;
      word = mb[++w];
    }
    for (; k; --k) word &= word - 1;
    oi = 32 * w + __ffs(word) - 1;
  };
  if (npos > 0 && spitch > 0)
    stage_rows<VEC>(mrow, spitch, kTile, length, [&](int t) -> const char* {
      return asg[t] >= 0 ? rows + (m0 + t) * pitch : nullptr;
    });
  if (npos > 0 && staged) {
    const i64 pad = round16(length);
    for (int r = warp; r < span; r += kTileWarps) {
      if (!cflag[r]) continue;
      const i64* srow = sc + (lo + r) * Vp;
      const i64 cnt = srow[V];
      const double count = static_cast<double>(cnt > 1 ? cnt : 1);
      char* cw = means + r * spitch;
      i64 part = 0;
      // kMeanLoads columns a lane: their loads all in flight, then the
      // divisions, which do not wait on each other
      for (int v0 = lane; v0 < V; v0 += 32 * kMeanLoads) {
        i64 sv[kMeanLoads];
#pragma unroll
        for (int u = 0; u < kMeanLoads; ++u)
          sv[u] = v0 + 32 * u < V ? srow[v0 + 32 * u] : 0;
#pragma unroll
        for (int u = 0; u < kMeanLoads; ++u) {
          const i64 x = static_cast<i64>(
              floor(__ddiv_rn(static_cast<double>(sv[u]), count)));
          if (v0 + 32 * u < V) {
            reinterpret_cast<T*>(cw)[v0 + 32 * u] = static_cast<T>(x);
            part += x;
          }
        }
      }
      for (i64 b = length + lane; b < pad; b += 32) cw[b] = 0;
      part = warp_reduce(part, Sum());
      if (lane == 0) cwt[r] = static_cast<double>(part);
    }
  }
  if (warp == 0) mmag[lane] = m_mag;
  copies_done();
  __syncthreads();                    // the rows, the means, mmag

  const int np = static_cast<int>(round16(length) / 16);
  for (int i = tid; i < npos; i += kTileThreads) {
    int t, oi;
    pair_of(i, t, oi);
    const i64 m = m0 + t;
    const i64 jc = asg[t] + oi - delta;
    const char* h = spitch > 0 ? mrow + t * spitch : rows + m * pitch;
    i64 dl;
    double cw_total;
    if (staged) {
      const int r = static_cast<int>(jc - lo);
      dl = 2 * staged_min_sum<T>(h, means + r * spitch, np);
      cw_total = cwt[r];
    } else {
      const i64* srow = sc + jc * Vp;
      const i64 cnt = srow[V];
      const double count = static_cast<double>(cnt > 1 ? cnt : 1);
      i64 s = 0, cs = 0;
      for (int v = 0; v < V; ++v) {
        const i64 x = static_cast<i64>(
            floor(__ddiv_rn(static_cast<double>(srow[v]), count)));
        const i64 c = static_cast<T>(x);
        const i64 y = reinterpret_cast<const T*>(h)[v];
        s += y < c ? y : c;
        cs += x;
      }
      dl = 2 * s;
      cw_total = static_cast<double>(cs);
    }
    const double frac = __ddiv_rn(static_cast<double>(dl),
                                  __dadd_rn(mmag[t], cw_total));
    const double d =
        __dmul_rn(10000.0, __dsub_rn(1.0, __dmul_rn(frac, frac)));
    dstore[oi * static_cast<i64>(M) + m] = d;
    const u64 key = static_cast<u64>(__double_as_longlong(d));
    if (staged)
      atomicMin(least + (jc - lo), key);
    else
      atomicMin(reinterpret_cast<u64*>(best_d + jc), key);
  }
  if (staged) {
    __syncthreads();                  // the span's least d
    for (int r = tid; r < span; r += kTileThreads)
      if (cflag[r])
        atomicMin(reinterpret_cast<u64*>(best_d + lo + r), least[r]);
  }
  if (tid == 0)
    atomicAdd(reinterpret_cast<u64*>(paths + (staged ? kDistStaged
                                                     : kDistGlobal)),
              1ull);
}

// ---------------------------------------------------------------------------
// pb_pick
// ---------------------------------------------------------------------------

// Two kinds of blocks in one launch, interleaved (zero, tie, zero, tie, ...
// while both last). A zero block clears sc for the next band, a warp a
// row: only the rows pb_band touched (count sc[c, V] > 0; every row it
// added into holds a count, so the others are zero throughout); lane 0
// reads the count before any lane stores, then 16-byte stores (a row is 8
// (V + 1) bytes, so every other row starts 8 bytes past a 16-byte
// boundary: its head word, and a tail word where one is left, are stored
// alone). A tie block takes a member a thread: each positive whose d
// (dstore, offset-major: a warp's members at one offset read adjacent
// doubles) equals its center's least puts the member's pool position into
// best_pos[center] (int64 atomicMin). The stores do not wait behind the
// ties' dependent loads and atomics.
__global__ void __launch_bounds__(kThreads)
pb_pick_kernel(int M, const i64* __restrict__ assign, int delta, int W,
               const unsigned* __restrict__ bits,
               const double* __restrict__ dstore,
               const double* __restrict__ best_d, i64* __restrict__ best_pos,
               i64 goff, i64* __restrict__ sc, int C, int V, int zero_blocks,
               int tie_blocks) {
  const int tid = threadIdx.x, b = blockIdx.x;
  const int both = zero_blocks < tie_blocks ? zero_blocks : tie_blocks;
  const bool zero = b < 2 * both ? (b & 1) == 0 : zero_blocks > tie_blocks;
  const int idx = b < 2 * both ? b >> 1 : b - both;
  if (zero) {
    const int lane = tid & 31;
    const i64 Vp = static_cast<i64>(V) + 1;
    for (i64 c = static_cast<i64>(idx) * kWarps + (tid >> 5); c < C;
         c += static_cast<i64>(zero_blocks) * kWarps) {
      i64* row = sc + c * Vp;
      i64 count = 0;
      if (lane == 0) count = row[V];
      if (__shfl_sync(0xffffffffu, count, 0) == 0) continue;
      const int head = static_cast<int>((reinterpret_cast<u64>(row) >> 3) & 1);
      const i64 pairs = (Vp - head) >> 1;
      if (lane == 0) {
        if (head) row[0] = 0;
        if ((Vp - head) & 1) row[Vp - 1] = 0;
      }
      longlong2* body = reinterpret_cast<longlong2*>(row + head);
      for (i64 p = lane; p < pairs; p += 32) body[p] = make_longlong2(0, 0);
    }
    return;
  }
  const i64 m = static_cast<i64>(idx) * kThreads + tid;
  if (m >= M) return;
  const i64 a = assign[m];
  for (int w = 0; w < W; ++w) {
    unsigned word = bits[m * W + w];
    while (word) {
      const int oi = 32 * w + __ffs(word) - 1;
      word &= word - 1;
      const i64 jc = a + oi - delta;
      if (dstore[oi * static_cast<i64>(M) + m] == best_d[jc])
        atomicMin(reinterpret_cast<long long*>(best_pos + jc), goff + m);
    }
  }
}

// ---------------------------------------------------------------------------
// pb_merge
// ---------------------------------------------------------------------------

// A tile's look-back descriptor (pb_merge's scratch, one a tile): its kept
// centers (bits 0-30) and its valid ones (bits 31-61), counted over the
// tile alone (kAggregate) or over it and every tile before it
// (kInclusive); 0 until the tile publishes.
constexpr u64 kAggregate = 1ull << 62, kInclusive = 2ull << 62;
constexpr u64 kFlags = 3ull << 62, kCountMask = (1ull << 31) - 1;
// pb_merge's group of lanes a center (a power of two): the lanes split a
// row's pieces and take the candidates' classifiers in turn, so a block of
// kThreads takes kWarps * 32 / lanes centers. The launch takes
// kMergeLanesLarge (one classifier round up to delta 16) where its grid
// of tiles fits on the card at once, else kMergeLanesSmall (4 times the
// centers a tile: a quarter of the tiles to wait for).
constexpr int kMergeLanesSmall = 4;
constexpr int kMergeLanesLarge = 16;
// The slots past its own that a tile stages for its candidates (further
// offsets read their slot from device memory).
constexpr int kMergeAhead = 64;

// Byte offsets of pb_merge's dynamic shared memory, laid out by the host
// (its size) and the kernel alike: the classifier's arrays, then per
// staged slot (the tile's own and up to kMergeAhead after them) the moved
// center, its mag, sq and length, per own slot its target t and new slot
// NP, and the staged slots' valid flags.
struct MergeSmem {
  i64 cm, mag, sq, len, t, np, valid, bytes;
};

__host__ __device__ inline MergeSmem merge_smem(i64 model, int per,
                                                int slots) {
  MergeSmem s;
  s.cm = round16(model);
  s.mag = s.cm + 8 * static_cast<i64>(slots);
  s.sq = s.mag + 8 * static_cast<i64>(slots);
  s.len = s.sq + 8 * static_cast<i64>(slots);
  s.t = s.len + 8 * static_cast<i64>(slots);
  s.np = s.t + 8 * static_cast<i64>(per);
  s.valid = s.np + 8 * static_cast<i64>(per);
  s.bytes = s.valid + slots;
  return s;
}

// man and dot of a candidate's row a against the center's row b, both in
// device memory (through L1: a tile's centers meet each row at several
// offsets), over the group of LANES lanes (in every lane of the group), a
// lane every LANES-th piece of VEC bytes; Acc<T> sums over kChunkPieces
// pieces of a lane, 64 bits across them.
template <typename T, int VEC, int LANES>
__device__ __forceinline__ void merge_sums(const char* a, const char* b,
                                           int length, int sub, i64& man,
                                           i64& dot) {
  typedef typename Acc<T>::type A;
  constexpr int kStep = LANES * kChunkPieces;
  man = 0;
  dot = 0;
  const int n = length / VEC;
  for (int p0 = sub; p0 < n; p0 += kStep) {
    const int p1 = n < p0 + kStep ? n : p0 + kStep;
    A m = 0, d = 0;
    for (int p = p0; p < p1; p += LANES)
      add_piece<T, VEC>(load_center<VEC>(a + static_cast<i64>(p) * VEC),
                        load_center<VEC>(b + static_cast<i64>(p) * VEC), m, d);
    man += m;
    dot += d;
  }
  man = group_sum(man, LANES);
  dot = group_sum(dot, LANES);
}

// The sum of the values (the flags cleared) of the descriptors of the
// tiles before `tile`, by decoupled look-back: the block reads kThreads
// descriptors at once, back to the nearest inclusive one (before tile 0:
// an inclusive 0), and reads them again while one between is unpublished.
// Every thread calls it and gets the sum.
__device__ u64 look_back(const u64* desc, i64 tile) {
  __shared__ int first;
  __shared__ u64 found;
  const int tid = threadIdx.x;
  u64 excl = 0;
  for (i64 hi = tile - 1; hi >= 0;) {
    const i64 q = hi - tid;
    const u64 d = q >= 0 ? *reinterpret_cast<const volatile u64*>(desc + q)
                         : kInclusive;
    if (tid == 0) first = kThreads;
    __syncthreads();
    if ((d & kFlags) == kInclusive) atomicMin(&first, tid);
    __syncthreads();
    const int f = first;
    if (!__syncthreads_and(tid > f || (d & kFlags) != 0)) continue;
    const i64 part = block_reduce(
        tid <= f ? static_cast<i64>(d & ~kFlags) : 0ll, Sum());
    if (tid == 0) found = static_cast<u64>(part);
    __syncthreads();
    excl += found;
    if (f < kThreads) break;
    hi -= kThreads;
  }
  return excl;
}

// A block a tile of `per` consecutive centers (a group of LANES lanes a
// center), numbered by a ticket in the order the
// blocks start, so that a block waits only on blocks that started before
// it.
//   Phase 1. A thread a slot of the tile and of the `ahead` after it
// stages the slot's moved center (its best member where it has one and is
// valid) and valid flag, each load chain once a slot and all in parallel;
// then the moved centers' mag, sq and length, all issued together. A
// group takes a center i: for its candidates i + 1 .. i + delta, as
// pb_band walks its offsets, man and dot over their rows in device memory
// (the lanes split the pieces); the lanes
// classify the candidates in turn (a: the candidate, b: center i), each
// keeping its first max of f1 (strict >, from DBL_MIN), and the group
// takes the greatest, the least offset on a tie: the first max over the
// offsets in order. t = the target (i when none, or when i is not valid).
//   Phase 2. The tile's kept centers (valid, t = i) and valid ones,
// scanned; the tile publishes its counts, then, once the look-back gives
// its prefix, its inclusive counts.
//   Phase 3. NP[k], each kept center's new slot; remap = NP[T], T the end
// of k's chain, where the chain ends inside the tile (followed in shared
// memory); the merged centers whose chain leaves the tile, listed in the
// scratch; t into t_row; the kept centers moved to their slots in place.
//   In place is safe: NP[k] <= k, so a block writes slots of its own tile
// or of earlier ones, which only blocks that started no later read (their
// own slots and the `ahead` after them); each publishes its counts after
// its last read of c_idx, c_valid and best_pos (a fence, then a barrier),
// and a block writes only once its look-back has seen every earlier tile
// publish.
//   The last block (ticket) follows the listed chains to their ends,
// writes their remap = NP[T], and clears the slots from the new kept total
// to the old (valid centers are a dense prefix of the slots, with c_idx 0
// past it); on a pass with no merge it does no C-sized work.
template <typename T, int VEC, int LANES>
__global__ void __launch_bounds__(kThreads)
pb_merge_kernel(const char* __restrict__ hist, i64 hpitch, int length, int C,
                i64* __restrict__ c_idx, uint8_t* __restrict__ c_valid,
                const i64* __restrict__ best_pos,
                const i64* __restrict__ m_all, i64 M_all,
                const double* __restrict__ mag, const double* __restrict__ sq,
                const double* __restrict__ lenf,
                const int* __restrict__ spec_g, int n_spec,
                const double* __restrict__ coef_g, int n_coef, int delta,
                int ahead, i64* __restrict__ t_row,
                i64* __restrict__ remap, i64* __restrict__ scr) {
  extern __shared__ __align__(16) char smem[];
  __shared__ i64 tile_s;
  constexpr int per = kWarps * (32 / LANES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane & (LANES - 1), grp = lane / LANES;
  const int slots = per + ahead;
  const MergeSmem L = merge_smem(
      n_coef * static_cast<i64>(sizeof(double)) + n_spec * 4, per, slots);
  double* model = reinterpret_cast<double*>(smem);
  i64* cm = reinterpret_cast<i64*>(smem + L.cm);
  double* smag = reinterpret_cast<double*>(smem + L.mag);
  double* ssq = reinterpret_cast<double*>(smem + L.sq);
  double* slen = reinterpret_cast<double*>(smem + L.len);
  i64* st = reinterpret_cast<i64*>(smem + L.t);
  i64* snp = reinterpret_cast<i64*>(smem + L.np);
  uint8_t* sv = reinterpret_cast<uint8_t*>(smem + L.valid);
  i64* NP = scr + kScratchHead;
  i64* list = NP + C;
  u64* desc = reinterpret_cast<u64*>(list + C);
  if (tid == 0)
    tile_s = static_cast<i64>(
        atomicAdd(reinterpret_cast<u64*>(scr + kTiles), 1ull));
  stage_model(model, spec_g, n_spec, coef_g, n_coef);
  const double* coef = model;
  const int* spec = reinterpret_cast<const int*>(model + n_coef);
  __syncthreads();
  const i64 tile = tile_s, base = tile * per;
  const int n_slots =
      C - base < slots ? static_cast<int>(C - base) : slots;
  for (int r = tid; r < n_slots; r += kThreads) {
    const i64 j = base + r;
    const bool v = c_valid[j];
    const i64 bp = best_pos[j], cj = c_idx[j];
    cm[r] = bp < M_all && v ? m_all[bp] : cj;
    sv[r] = v;
  }
  __syncthreads();
  for (int r = tid; r < n_slots; r += kThreads) {
    const i64 c = cm[r];
    smag[r] = mag[c];
    ssq[r] = sq[c];
    slen[r] = lenf[c];
  }
  __syncthreads();

  const int li = warp * (32 / LANES) + grp;
  const i64 i = base + li;
  const bool have = i < C;
  const bool vi = have && sv[li];
  const char* b_row = hist + (have ? cm[li] : 0) * hpitch;
  const double mag_b = have ? smag[li] : 0.0, sq_b = have ? ssq[li] : 0.0,
               len_b = have ? slen[li] : 0.0;
  double best_f1 = kDblMin;
  int best_o = delta;
  for (int o0 = 0; o0 < delta; o0 += LANES) {
    // the lanes' sums of LANES offsets; lane o - o0 keeps offset o's
    i64 my_man = 0, my_dot = 0, my_c = -1;
    int my_r = -1;
    for (int u = 0; u < LANES && o0 + u < delta; ++u) {
      const i64 j = i + o0 + u + 1;
      const int r = static_cast<int>(j - base);
      i64 c = 0;
      bool ok = vi && j < C;
      if (ok && r < slots) {
        c = cm[r];
        ok = sv[r] != 0;
      } else if (ok) {
        const bool v = c_valid[j];
        const i64 bp = best_pos[j];
        c = bp < M_all && v ? m_all[bp] : c_idx[j];
        ok = v;
      }
      i64 man, dot;
      merge_sums<T, VEC, LANES>(hist + c * hpitch, b_row, ok ? length : 0,
                                sub, man, dot);
      if (sub == u && ok) {
        my_man = man;
        my_dot = dot;
        my_c = c;
        my_r = r < slots ? r : -1;
      }
    }
    if (my_c >= 0) {
      double f1;
      const bool pos = classify(
          spec, coef, static_cast<double>(my_man), static_cast<double>(my_dot),
          my_r >= 0 ? smag[my_r] : mag[my_c], mag_b,
          my_r >= 0 ? ssq[my_r] : sq[my_c], sq_b,
          my_r >= 0 ? slen[my_r] : lenf[my_c], len_b, &f1);
      if (pos && f1 > best_f1) {
        best_f1 = f1;
        best_o = o0 + sub;
      }
    }
  }
#pragma unroll
  for (int s = LANES >> 1; s; s >>= 1) {
    const double f = __shfl_xor_sync(0xffffffffu, best_f1, s);
    const int o = __shfl_xor_sync(0xffffffffu, best_o, s);
    if (f > best_f1 || (f == best_f1 && o < best_o)) {
      best_f1 = f;
      best_o = o;
    }
  }
  if (have && sub == 0) st[li] = vi && best_o < delta ? i + best_o + 1 : i;
  __syncthreads();

  // phase 2, a thread an own slot: kept counted in the scan's low 16 bits,
  // valid in its high
  const i64 k = base + tid;
  const bool own = tid < per && k < C;
  const bool kept = own && sv[tid] && st[tid] == k;
  int total;
  const int incl =
      block_scan((own && sv[tid] ? 1 << 16 : 0) | (kept ? 1 : 0), &total);
  const u64 agg = static_cast<u64>(total & 0xffff) |
                  (static_cast<u64>(total >> 16) << 31);
  __threadfence();                    // the last reads of c_idx, c_valid
  __syncthreads();                    // and best_pos, before the counts
  if (tid == 0 && tile > 0)
    atomicExch(reinterpret_cast<u64*>(desc + tile), kAggregate | agg);
  const u64 excl = look_back(desc, tile);
  __threadfence();                    // the earlier tiles' counts seen
  if (tid == 0)
    atomicExch(reinterpret_cast<u64*>(desc + tile), kInclusive | (excl + agg));

  // phase 3: NP of k (the kept centers up to k, less one) where k ends a
  // chain: kept, or not valid (its own end, as the plain merge's remap)
  const i64 np = static_cast<i64>(excl & kCountMask) + (incl & 0xffff) - 1;
  if (kept) {
    snp[tid] = np;
    NP[k] = np;
  }
  __syncthreads();
  if (own) {
    i64 x = st[tid];
    t_row[k] = x;
    while (x < base + per && st[x - base] != x) x = st[x - base];
    if (x == k)
      remap[k] = np;
    else if (x < base + per)
      remap[k] = snp[x - base];
    else
      list[atomicAdd(reinterpret_cast<u64*>(scr + kMerged), 1ull)] = k;
    if (kept) {
      c_idx[np] = cm[tid];
      c_valid[np] = 1;
    }
  }
  if (!last_block(scr + kTicket, gridDim.x)) return;

  const u64 all = static_cast<u64>(
      __ldcg(reinterpret_cast<const i64*>(desc) + gridDim.x - 1));
  const i64 kept_total = static_cast<i64>(all & kCountMask);
  const i64 valid_total = static_cast<i64>((all >> 31) & kCountMask);
  for (i64 s = kept_total + tid; s < valid_total; s += kThreads) {
    c_idx[s] = 0;
    c_valid[s] = 0;
  }
  const i64 n = __ldcg(scr + kMerged);
  for (i64 q = tid; q < n; q += kThreads) {
    const i64 km = __ldcg(list + q);
    i64 x = __ldcg(t_row + km);
    for (i64 y = __ldcg(t_row + x); y != x; y = __ldcg(t_row + x)) x = y;
    remap[km] = __ldcg(NP + x);
  }
  for (i64 q = tid; q < static_cast<i64>(gridDim.x); q += kThreads)
    desc[q] = 0;
  if (tid == 0) {
    scr[kMerged] = 0;
    scr[kTiles] = 0;
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
static int words(int delta) { return (2 * delta + 1 + 31) / 32; }

// The classifier's shared memory (ops/classifier.py:Model keeps it below the
// 48 KB a launch may take without an attribute).
static size_t model_bytes(int n_spec, int n_coef) {
  return n_coef * sizeof(double) + n_spec * sizeof(int);
}

// A staged row's pitch in shared memory: its 16-byte pieces, an odd number
// of them, so that the 8 lanes of a quarter warp reading 16 bytes of 8
// rows at one column meet 8 distinct bank groups; 0 where a tile's member
// rows and one center row do not fit kStageBytes (every tile then takes
// the global path).
static int stage_pitch(i64 length) {
  const i64 pitch = 16 * (((length + 15) / 16) | 1);
  return (kTile + 1) * pitch <= kStageBytes ? static_cast<int>(pitch) : 0;
}

// The center rows a tile may stage: kSpanRows, or fewer where kStageBytes
// holds fewer beside its member rows, or span_cap where that is smaller
// and not negative (the tests' way to send tiles down the global path).
static int stage_cap(int spitch, int span_cap) {
  if (spitch == 0) return 0;
  int cap = (kStageBytes - kTile * spitch) / spitch;
  cap = cap < kSpanRows ? cap : kSpanRows;
  return span_cap >= 0 && span_cap < cap ? span_cap : cap;
}

// Launch with `bytes` of dynamic shared memory, past 48 KB by the
// kernel's attribute.
template <class K>
static void allow_smem(K kernel, i64 bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

template <typename T, int VEC>
static int launch_band(cudaStream_t s, const void* rows, i64 pitch,
                       const void* hist, i64 hpitch, i64 length, int V,
                       const void* m_idx, const void* m_valid, int M,
                       void* assign, const void* remap, const void* c_idx,
                       const void* c_valid, int C, const void* mag,
                       const void* sq, const void* lenf, const void* spec,
                       int n_spec, const void* coef, int n_coef, int delta,
                       void* bits, void* sc, void* best_d, void* best_pos,
                       long long m_all, int span_cap, void* paths) {
  const int spitch = stage_pitch(length);
  const int cap = stage_cap(spitch, span_cap);
  const i64 bytes =
      tile_smem(model_bytes(n_spec, n_coef), spitch, cap, true).bytes;
  allow_smem(pb_band_kernel<T, VEC>, bytes);
  pb_band_kernel<T, VEC><<<tiles(M), kTileThreads, bytes, s>>>(
      static_cast<const char*>(rows), pitch, static_cast<const char*>(hist),
      hpitch, V, static_cast<int>(length), static_cast<const i64*>(m_idx),
      static_cast<const uint8_t*>(m_valid), M, static_cast<i64*>(assign),
      static_cast<const i64*>(remap), static_cast<const i64*>(c_idx),
      static_cast<const uint8_t*>(c_valid), C,
      static_cast<const double*>(mag), static_cast<const double*>(sq),
      static_cast<const double*>(lenf), static_cast<const int*>(spec),
      n_spec, static_cast<const double*>(coef), n_coef, delta, words(delta),
      spitch, cap, static_cast<unsigned*>(bits), static_cast<i64*>(sc),
      static_cast<double*>(best_d), static_cast<i64*>(best_pos), m_all,
      static_cast<i64*>(paths));
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
                          int span_cap, void* paths, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 pitch = stride * width, hpitch = hstride * width;
  const i64 length = static_cast<i64>(V) * width;
  const int vec = pair_piece(rows, pitch, hist, hpitch, length, width);
#define MC_BAND(T, VEC)                                                     \
  case VEC:                                                                 \
    return launch_band<T, VEC>(s, rows, pitch, hist, hpitch, length, V,     \
                               m_idx, m_valid, M, assign, remap, c_idx,     \
                               c_valid, C, mag, sq, lenf, spec, n_spec,     \
                               coef, n_coef, delta, bits, sc, best_d,       \
                               best_pos, m_all, span_cap, paths)
  MC_ROW_CASES(MC_BAND);
#undef MC_BAND
}

template <typename T, int VEC>
static int launch_dist(cudaStream_t s, const void* rows, i64 pitch, int V,
                       i64 length, const void* m_idx, int M,
                       const void* assign, const void* mag, int delta,
                       const void* bits, const void* sc, void* dstore,
                       void* best_d, int span_cap, void* paths) {
  const int spitch = stage_pitch(length);
  const int cap = stage_cap(spitch, span_cap);
  const i64 bytes = tile_smem(0, spitch, cap, false).bytes;
  allow_smem(pb_dist_kernel<T, VEC>, bytes);
  pb_dist_kernel<T, VEC><<<tiles(M), kTileThreads, bytes, s>>>(
      static_cast<const char*>(rows), pitch, V, static_cast<int>(length),
      static_cast<const i64*>(m_idx), M, static_cast<const i64*>(assign),
      static_cast<const double*>(mag), delta, words(delta), spitch, cap,
      static_cast<const unsigned*>(bits), static_cast<const i64*>(sc),
      static_cast<double*>(dstore), static_cast<double*>(best_d),
      static_cast<i64*>(paths));
  return cudaGetLastError();
}

extern "C" int mc_pb_dist(const void* rows, long long stride, int V,
                          int width, const void* m_idx, int M,
                          const void* assign, const void* mag, int delta,
                          const void* bits, const void* sc, void* dstore,
                          void* best_d, int span_cap, void* paths,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 pitch = stride * width, length = static_cast<i64>(V) * width;
  const int vec = piece_bytes(rows, pitch, length, width);
#define MC_DIST(T, VEC)                                                    \
  case VEC:                                                                \
    return launch_dist<T, VEC>(s, rows, pitch, V, length, m_idx, M,        \
                               assign, mag, delta, bits, sc, dstore,       \
                               best_d, span_cap, paths)
  MC_ROW_CASES(MC_DIST);
#undef MC_DIST
}

extern "C" int mc_pb_pick(int M, const void* assign, int delta,
                          const void* bits, const void* dstore,
                          const void* best_d, void* best_pos, long long goff,
                          void* sc, int C, int V, void* stream) {
  // a warp a row of sc in the zero blocks, a thread a member in the others
  const int zero_blocks = C > 0 ? (C + kWarps - 1) / kWarps : 0;
  const int tie_blocks = thread_blocks(M);
  pb_pick_kernel<<<zero_blocks + tie_blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      M, static_cast<const i64*>(assign), delta, words(delta),
      static_cast<const unsigned*>(bits), static_cast<const double*>(dstore),
      static_cast<const double*>(best_d), static_cast<i64*>(best_pos), goff,
      static_cast<i64*>(sc), C, V, zero_blocks, tie_blocks);
  return cudaGetLastError();
}

// One launch of pb_merge at LANES lanes a center; its grid's tiles, and,
// with fits, only whether the card holds them all at once (no launch).
template <typename T, int VEC, int LANES>
static int launch_merge_at(cudaStream_t s, const void* hist, i64 hpitch,
                           i64 length, int C, void* c_idx, void* c_valid,
                           const void* best_pos, const void* m_all,
                           long long M_all, const void* mag, const void* sq,
                           const void* lenf, const void* spec, int n_spec,
                           const void* coef, int n_coef, int delta,
                           void* t_row, void* remap, void* scratch,
                           bool* fits) {
  constexpr int per = kWarps * (32 / LANES);
  const int ahead = delta < kMergeAhead ? delta : kMergeAhead;
  const int slots = per + ahead;
  const i64 bytes = merge_smem(model_bytes(n_spec, n_coef), per, slots).bytes;
  const int tiles = (C + per - 1) / per;
  if (fits != nullptr) {
    // the card's resident blocks at these shared bytes, queried once
    static i64 seen = -1;
    static int resident = 0;
    if (bytes != seen) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      allow_smem(pb_merge_kernel<T, VEC, LANES>, bytes);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pb_merge_kernel<T, VEC, LANES>, kThreads, bytes);
      seen = bytes;
      resident = sms * per_sm;
    }
    *fits = tiles <= resident;
    return cudaGetLastError();
  }
  allow_smem(pb_merge_kernel<T, VEC, LANES>, bytes);
  pb_merge_kernel<T, VEC, LANES><<<tiles, kThreads, bytes, s>>>(
      static_cast<const char*>(hist), hpitch, static_cast<int>(length), C,
      static_cast<i64*>(c_idx), static_cast<uint8_t*>(c_valid),
      static_cast<const i64*>(best_pos), static_cast<const i64*>(m_all),
      M_all, static_cast<const double*>(mag), static_cast<const double*>(sq),
      static_cast<const double*>(lenf), static_cast<const int*>(spec),
      n_spec, static_cast<const double*>(coef), n_coef, delta, ahead,
      static_cast<i64*>(t_row), static_cast<i64*>(remap),
      static_cast<i64*>(scratch));
  return cudaGetLastError();
}

// kMergeLanesLarge where its tiles all fit on the card at once, else
// kMergeLanesSmall.
template <typename T, int VEC>
static int launch_merge(cudaStream_t s, const void* hist, i64 hpitch,
                        i64 length, int C, void* c_idx, void* c_valid,
                        const void* best_pos, const void* m_all,
                        long long M_all, const void* mag, const void* sq,
                        const void* lenf, const void* spec, int n_spec,
                        const void* coef, int n_coef, int delta, void* t_row,
                        void* remap, void* scratch) {
  bool large = false;
  const int err = launch_merge_at<T, VEC, kMergeLanesLarge>(
      s, hist, hpitch, length, C, c_idx, c_valid, best_pos, m_all, M_all,
      mag, sq, lenf, spec, n_spec, coef, n_coef, delta, t_row, remap,
      scratch, &large);
  if (err != cudaSuccess) return err;
  return large ? launch_merge_at<T, VEC, kMergeLanesLarge>(
                     s, hist, hpitch, length, C, c_idx, c_valid, best_pos,
                     m_all, M_all, mag, sq, lenf, spec, n_spec, coef, n_coef,
                     delta, t_row, remap, scratch, nullptr)
               : launch_merge_at<T, VEC, kMergeLanesSmall>(
                     s, hist, hpitch, length, C, c_idx, c_valid, best_pos,
                     m_all, M_all, mag, sq, lenf, spec, n_spec, coef, n_coef,
                     delta, t_row, remap, scratch, nullptr);
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
