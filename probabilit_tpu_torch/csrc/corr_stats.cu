// corr_stats.cu: the score statistics of a correlated graph's K drivers.
//
// Replaces probabilit_tpu/engine/pallas_exec.py::_make_stats_kernel (the
// TPU's pass-1 kernel, called from _recolor_transform).  For every sample
// i in [start, start + n) it redraws the uniforms of the K correlated
// columns from the same Philox4x32-10 stream as the generated graph
// megakernel (sample i is word i & 3 of the call at counter
// (g mod 2^32, g >> 32, column, 0), g = i >> 2), turns them into normal
// scores z = ndtri_fast(u), and sums z_k and z_j z_k (upper triangle,
// row-major): P = K + K(K+1)/2 sums.  engine/cuda_exec.py::recolor_transform
// adds the per-block float64 partials and solves the K x K recolour
// transform (A, b) that the megakernel's RECOLOR rows apply.
//
// Unlike the TPU kernel, it draws exactly the columns plan.col_of[v] of
// the correlated variables (the counter carries the column), so the main
// kernel needs no reordered draw.
//
// What bounds it on an H100: instruction issue.  Per group of four samples
// and column it does one Philox call (ten rounds of two 32x32->64-bit
// multiplies and two 3-input XORs, all four words used) and four Giles
// ndtri evaluations (a log, a 9-term polynomial); the cross products are
// K(K+1)/2 a sample.  It reads nothing and writes P doubles per block.
//
// What the design does about it:
// * The Gram sums run on the tensor cores.  A warp scores a tile of S
//   samples of all K columns into shared memory (each lane whole Philox
//   calls: four samples of one column), split into TF32 halves
//   hi = rna(z), lo = rna(z - hi), then runs mma.m16n8k8 (TF32 in, float32
//   out) with the samples as the product's depth.  Up to K = 8 the
//   product's rows are the hi and the lo halves of eight rows (the K
//   columns, a row of ones for the z_k sums where it fits, in 8 / R sets
//   of R rows with their own samples) and its columns their hi halves:
//   one product a k-step gives hi.hi and lo.hi.  Above K = 8 the rows and
//   columns are the K columns padded to 16 (a row of ones below K = 16):
//   hi.hi and hi.lo of two column tiles.  Either way the third product is
//   the transpose of the second, added when the block reduces.  K = 4, 8
//   and 16 sum z_k from the B fragments with float adds.
// * Each warp scores tile i while the products of tile i - 1 (the other
//   of its two tiles) run a few k-steps after each Philox call; ldmatrix
//   reads the fragments, each row's 16-byte chunks swizzled so the eight
//   rows of a matrix and a quarter-warp's stores hit distinct banks.
// * No float32 accumulator carries more than kFlushSamples samples: the
//   tensor core truncates as it adds, so a diagonal sum drifts low by
//   about 2.6e-6 of itself over runs of 512 (H100, 1e8 samples), half that
//   over 256.  The fragments are then added into float64 registers, and
//   the block adds its warps' float64 sums in warp order.  No atomics: a
//   seed gives the same sums on every run of a card.
// * The Giles tail polynomial and its square root run only where a lane
//   of the warp needs them (__any_sync): about 0.34% of scores have
//   w >= 5, so about 10% of a warp's scores of one word see the branch.
//   Each score is bit for bit sampling_math's ndtri_fast.
// * The Philox round keys and the columns are launch parameters, read
//   from constant memory instead of held in registers.
// On an H100 an mma.sync does not overlap the FP32 and integer work of
// its sub-partition (tools/torch_corr_stats_ab.py --tensor-probe): each
// product costs 15-31 cycles of it here, more than the FP32 multiply-adds
// it replaces up to K = 4 and less above K = 8 (PERF.md).
// The first and the last tile of a launch may hold samples outside
// [start, start + n): they score 0 and add nothing.  chip_smoke.py prints
// ptxas's registers and spill bytes for each K and fails on a spill.

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"

namespace {

// Must equal MAX_CORR_K in engine/cuda_exec.py.
constexpr int kMaxCorr = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFlushSamples = 256;  // samples a float32 accumulator carries at most
constexpr int kMatCols = 20;        // a warp's float64 matrix: 16 columns, 4 lanes' z sums

template <int K>
struct Tile {
  // Up to K = 8 the product's 16 rows are the hi and the lo halves of
  // eight rows (K columns, a row of ones at K while K < 8, zeros), in
  // sets of R rows: 8 / R sets of samples share each k-step.
  static constexpr bool kStacked = K <= 8;
  // The z_k sums come from a row of ones in the product where it fits and
  // costs no set (K = 4 would need eight rows with it, four without);
  // else from float adds of the B fragments (K = 4, 8, 16).
  static constexpr bool kOnesRow = K != 4 && K != 8 && K != 16;
  static constexpr int kRows = K + kOnesRow <= 2 ? 2 : (K + kOnesRow <= 4 ? 4 : 8);  // R
  static constexpr int kSets = kStacked ? 8 / kRows : 1;
  // S, samples a warp scores at once: a whole number of Philox calls a
  // lane where it can, and the tiles (two a warp) within the blocks an SM
  // should hold.
  static constexpr int kSamples = K <= 6 ? 128 : (K <= 14 ? 64 : 32);
  static constexpr int kGroups = kSamples / 4;        // Philox calls per column
  static constexpr int kCalls = (K * kGroups + 31) / 32;  // per lane, the last may idle
  static constexpr int kSetGroups = kGroups / kSets;  // a set's chunks of a row
  static constexpr int kSteps = kSamples / (8 * kSets);  // mma k-steps a tile
  static constexpr int kFlushTiles = kFlushSamples / kSamples;
  // Blocks an SM should hold: the register budget (65536 / 256 / kMinBlocks a thread).
  static constexpr int kMinBlocks = K <= 8 ? 3 : 2;
  // Each warp's two tiles (hi, then lo, K rows of S floats each), then a
  // row of ones and a row of zeros that the fragments of rows past K read.
  static constexpr int kTileFloats = 2 * K * kSamples;
  static constexpr int kTileBytes = (kWarps * 2 * kTileFloats + 2 * kSamples) * 4;
  static constexpr int kMatBytes = kWarps * 16 * kMatCols * 8;
  static constexpr int kSmemBytes = kTileBytes > kMatBytes ? kTileBytes : kMatBytes;
  static_assert(kSetGroups % 8 == 0, "a set spans whole 8-chunk swizzle blocks");
  static_assert(kSteps >= 1, "a tile holds at least one k-step a set");
};

// The swizzle key of row r's group a: chunk a of a row lies at a ^ key, so
// the eight rows of an ldmatrix matrix and a quarter-warp's stores (one
// row, eight groups) hit distinct banks.  Up to K = 8 the key is the
// row's place in the product, R set + r.
template <int K>
__device__ __forceinline__ int swizzle_key(int r, int a) {
  using T = Tile<K>;
  return T::kStacked ? T::kRows * (a / T::kSetGroups) + r : (r & 7);
}

// cvt.rna.tf32.f32 of a finite float: the magnitude rounded to 10
// mantissa bits, ties away from zero, on the bit pattern (two integer
// instructions; the cvt itself also tests for infinities and NaNs).
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// d += a b for one m16n8k8 TF32 tile (PTX fragment layouts, lane =
// 4 gid + t: a0..a3 are rows gid, gid + 8 at depth t, then at depth t + 4;
// b0, b1 depths t, t + 4 of column gid; d0..d3 rows gid, gid, gid + 8,
// gid + 8 at columns 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix of four (two) 8 x 4 float matrices, rows at the addresses lanes
// 0-7, 8-15, 16-23, 24-31 give: register i of lane 4 gid + t holds float
// t of row gid of matrix i, which is how the fragments above lie.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// The four scores of a Philox call, each bit for bit
// sampling_math::ndtri_fast(bits_to_open_unit(word)): the central
// polynomial for every lane, the tail (w >= 5) only under a warp vote.
// Three clamps of that path never bind on a word's uniform, so they are
// left out: u = f - 1 (f in [1, 2) from the top 23 bits) is at most
// 1 - 2^-23, so min(u, 1 - 2^-24) is u; x = 2 u - 1 is 2 f - 3 exactly,
// and max(u, 2^-24) becomes max(x, 2^-23 - 1); then 1 - x^2 >= 2^-22, so
// the log's argument needs no floor at 1e-37 and w <= 15.25 no cap at
// 16.64.  The log is __logf's own lg2.approx times ln 2, in its flush-to-
// zero form (the argument is a normal float, so the two agree) and with
// the product kept apart from the polynomial's first subtraction, as
// __logf keeps it.  `live` is false on a lane whose call is padding;
// every lane of the warp must call this together.
__device__ __forceinline__ void scores(uint4 words, bool live, float (&z)[4]) {
  const uint32_t bits[4] = {words.x, words.y, words.z, words.w};
  float x[4], w[4], p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float f = __uint_as_float((bits[j] >> 9) | 0x3F800000u);
    x[j] = fmaxf(2.0f * f - 3.0f, -0.99999988079071044921875f);  // 2^-23 - 1
    float lg2;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg2) : "f"((1.0f - x[j]) * (1.0f + x[j])));
    w[j] = -__fmul_rn(lg2, 0.69314718246459960938f);
    p[j] = sampling_math::giles_central(w[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (__any_sync(0xFFFFFFFFu, live && w[j] >= 5.0f)) {
      const float p2 = sampling_math::giles_tail(sampling_math::sqrt_approx(w[j]) - 3.0f);
      p[j] = w[j] < 5.0f ? p[j] : p2;
    }
    z[j] = 1.4142135623730951f * (p[j] * x[j]);
  }
}

// The Philox columns of the K drivers, a launch parameter.
struct Columns {
  uint32_t c[kMaxCorr];
};

template <int K>
__global__ void __launch_bounds__(kThreads, Tile<K>::kMinBlocks)
    corr_stats(const __grid_constant__ Columns columns,
               const __grid_constant__ sampling_math::PhiloxKeys keys, int64_t start, int64_t n,
               double* __restrict__ partials) {
  static_assert(K >= 1 && K <= kMaxCorr, "1..kMaxCorr correlated columns");
  using T = Tile<K>;
  constexpr int S = T::kSamples;
  constexpr int G = T::kGroups;
  constexpr int P = K + K * (K + 1) / 2;
  extern __shared__ float4 smem[];
  float* const tiles_base = reinterpret_cast<float*>(smem);
  float* const ones_row = tiles_base + kWarps * 2 * T::kTileFloats;
  float* const zeros_row = ones_row + S;
  for (int i = threadIdx.x; i < S; i += kThreads) ones_row[i] = 1.0f, zeros_row[i] = 0.0f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This warp's two tiles, each hi then lo, K rows of S floats: the warp
  // scores a tile into one while its products read the other, the tile
  // before.  The second starts at zero, the "tile before" the first.
  float* const tile_hi = tiles_base + warp * 2 * T::kTileFloats;
  float* const tile_lo = tile_hi + K * S;
  for (int i = lane; i < T::kTileFloats; i += 32) tile_hi[T::kTileFloats + i] = 0.0f;

  // Call c of this lane scores group a = lane % G of column row c =
  // (32 c + lane) / G of the tile, and stores it at offset at c.
  const int a = lane % G;
  uint32_t col[T::kCalls];
  int at[T::kCalls];
#pragma unroll
  for (int c = 0; c < T::kCalls; ++c) {
    const int row = (32 * c + lane) / G;
    col[c] = columns.c[row < K ? row : 0];
    at[c] = row * S + 4 * (a ^ swizzle_key<K>(row, a));
  }

  // Fragments come from the tile by ldmatrix: an 8 x 4 matrix is one
  // 16-byte chunk (four depths) of eight rows; k-step s reads chunks 2 s
  // (depths 0-3) and 2 s + 1 (depths 4-7) of a set's range.
  // Up to K = 8: A's matrices are the hi rows 0-7 and the lo rows 0-7 of
  // chunk 2 s, then of chunk 2 s + 1 (row R set + r is column r of a set),
  // and B is A's hi rows.  Above: A's matrices are
  // rows 0-7 and 8-15 of chunk 2 s, then of 2 s + 1; B's (both column
  // tiles) rows 0-7 of chunks 2 s, 2 s + 1, then rows 8-15.  Rows past K
  // read a row of ones (row K, hi; its lo is 0) or of zeros.
  const int gid = lane >> 2;
  const int t = lane & 3;
  const int m = lane >> 3;
  auto place = [&](int row, int half, bool lo, uint32_t& base, uint32_t& next, uint32_t (&off)[4]) {
    // `row` is the product's row (0-15): its set, column and source row.
    const int set = T::kStacked ? (row & 7) / T::kRows : 0;
    const int r = T::kStacked ? (row & 7) % T::kRows : row;
    const float* src = r < K ? (lo ? tile_lo : tile_hi) + r * S
                             : (r == K && T::kOnesRow && !lo ? ones_row : zeros_row);
    base = static_cast<uint32_t>(__cvta_generic_to_shared(src)) + 16 * set * T::kSetGroups;
    next = r < K ? 4 * T::kTileFloats : 0;  // the other tile's row
    const int key = T::kStacked ? row & 7 : (r & 7);
#pragma unroll
    for (int i = 0; i < 4; ++i) off[i] = 16 * ((2 * i + half) ^ key);
  };
  uint32_t a_hi, a_hi_next, a_off[4];
  uint32_t b_hi = 0, b_hi_next = 0, b_off[4] = {}, b_lo = 0, b_lo_next = 0, b_lo_off[4] = {};
  if (T::kStacked) {
    place(lane & 7, m >> 1, m & 1, a_hi, a_hi_next, a_off);  // hi rows, then lo rows
  } else {
    place((lane & 7) + 8 * (m & 1), m >> 1, false, a_hi, a_hi_next, a_off);
    place((lane & 7) + 8 * (m >> 1), m & 1, false, b_hi, b_hi_next, b_off);
    place((lane & 7) + 8 * (m >> 1), m & 1, true, b_lo, b_lo_next, b_lo_off);
  }
  // Above K = 8, hi.lo counts twice on a column row (lo.hi is its
  // transpose), once on the ones row (whose lo is 0).  The accumulators'
  // rows are gid, gid + 8.
  const float twice_a = T::kOnesRow && gid == K ? 1.0f : 2.0f;
  const float twice_b = T::kOnesRow && gid + 8 == K ? 1.0f : 2.0f;
  __syncthreads();  // the ones and zeros rows

  // Up to K = 8 one accumulator: rows gid (hi.hi) and gid + 8 (lo.hi);
  // above, hi.hi and hi.lo of each column tile.  K = 8 and 16 also sum
  // the z of B's columns (gid, gid + 8) at this lane's depths.
  float acc[4] = {}, hh0[4] = {}, hl0[4] = {}, hh1[4] = {}, hl1[4] = {}, za = 0.0f, zb = 0.0f;
  double e0[4] = {}, e1[4] = {}, eza = 0.0, ezb = 0.0;
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (T::kStacked) {
        e0[i] += static_cast<double>(acc[i]);
        acc[i] = 0.0f;
      } else {
        const float twice = i < 2 ? twice_a : twice_b;
        e0[i] += static_cast<double>(fmaf(twice, hl0[i], hh0[i]));
        e1[i] += static_cast<double>(fmaf(twice, hl1[i], hh1[i]));
        hh0[i] = hl0[i] = hh1[i] = hl1[i] = 0.0f;
      }
    }
    if (!T::kOnesRow) {
      eza += static_cast<double>(za);
      ezb += static_cast<double>(zb);
      za = zb = 0.0f;
    }
  };

  // One k-step of the products of the tile before (`before` selects its
  // slot): fragments by ldmatrix, then the products.
  auto mma_step = [&](int step, uint32_t before) {
    const uint32_t far = 128 * (step >> 2);  // past the first four k-steps
    if (T::kStacked) {
      // B (hi rows 0-7 at depths t, t + 4) is A's registers 0 and 2.
      uint32_t ah[4];
      ldsm_x4(ah, a_hi + before * a_hi_next + a_off[step & 3] + far);
      const uint32_t bh[2] = {ah[0], ah[2]};
      mma_tf32(acc, ah, bh[0], bh[1]);
      if (!T::kOnesRow) {  // K = 4, 8: B's column gid, hi and lo (A's rows gid + 8)
        za += __uint_as_float(bh[0]) + __uint_as_float(ah[1]);
        za += __uint_as_float(bh[1]) + __uint_as_float(ah[3]);
      }
    } else {
      uint32_t ah[4], bh[4], bl[4];
      ldsm_x4(ah, a_hi + before * a_hi_next + a_off[step & 3] + far);
      ldsm_x4(bh, b_hi + before * b_hi_next + b_off[step & 3] + far);
      ldsm_x4(bl, b_lo + before * b_lo_next + b_lo_off[step & 3] + far);
      mma_tf32(hh0, ah, bh[0], bh[1]);
      mma_tf32(hl0, ah, bl[0], bl[1]);
      mma_tf32(hh1, ah, bh[2], bh[3]);
      mma_tf32(hl1, ah, bl[2], bl[3]);
      if (!T::kOnesRow) {  // K = 16: B's columns gid and gid + 8
        za += __uint_as_float(bh[0]) + __uint_as_float(bl[0]);
        za += __uint_as_float(bh[1]) + __uint_as_float(bl[1]);
        zb += __uint_as_float(bh[2]) + __uint_as_float(bl[2]);
        zb += __uint_as_float(bh[3]) + __uint_as_float(bl[3]);
      }
    }
  };

  // Tiles of G groups from group first >> 2 on cover samples
  // start .. start + n - 1; warp w of the grid takes tiles w, w + warps, ...
  const uint64_t first = static_cast<uint64_t>(start);
  const uint64_t end = first + static_cast<uint64_t>(n);
  const uint64_t g_first = first >> 2;
  const uint64_t tiles = (((end - 1) >> 2) + 1 - g_first + G - 1) / G;
  const uint64_t warps = static_cast<uint64_t>(gridDim.x) * kWarps;
  // Each pass scores tile i into slot i & 1 and, after each Philox call, a
  // share of the k-steps of tile i - 1 (the other slot): the tensor
  // cores' work spreads over the pass.
  int since_flush = 0;
  uint32_t slot = 0;
  bool any = false;
  for (uint64_t tile = static_cast<uint64_t>(blockIdx.x) * kWarps + warp; tile < tiles;
       tile += warps, slot ^= 1) {
    const uint64_t g0 = g_first + tile * G;
    const uint64_t g = g0 + a;
    const bool whole = (g0 << 2) >= first && ((g0 + G) << 2) <= end;
    float* const hi_now = tile_hi + slot * T::kTileFloats;
    float* const lo_now = tile_lo + slot * T::kTileFloats;
    any = true;
#pragma unroll
    for (int c = 0; c < T::kCalls; ++c) {
      constexpr bool kPadded = T::kCalls * 32 > K * G;  // the last call idles on some lanes
      const bool live = !kPadded || c + 1 < T::kCalls || 32 * c + lane < K * G;
      float z[4];
      scores(sampling_math::philox_group(g, col[c], keys), live, z);
      float4 hi, lo;
      hi.x = tf32_rna(z[0]);
      hi.y = tf32_rna(z[1]);
      hi.z = tf32_rna(z[2]);
      hi.w = tf32_rna(z[3]);
      lo.x = tf32_rna(z[0] - hi.x);
      lo.y = tf32_rna(z[1] - hi.y);
      lo.z = tf32_rna(z[2] - hi.z);
      lo.w = tf32_rna(z[3] - hi.w);
      if (live) {
        *reinterpret_cast<float4*>(hi_now + at[c]) = hi;
        *reinterpret_cast<float4*>(lo_now + at[c]) = lo;
      }
#pragma unroll
      for (int step = c * T::kSteps / T::kCalls; step < (c + 1) * T::kSteps / T::kCalls; ++step) {
        mma_step(step, slot ^ 1);
      }
    }
    if (__builtin_expect(!whole, 0)) {  // the first or last tile: zero what lies outside
#pragma unroll
      for (int c = 0; c < T::kCalls; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t i = (g << 2) + j;
          if ((i < first || i >= end) && 32 * c + lane < K * G) {
            hi_now[at[c] + j] = 0.0f;
            lo_now[at[c] + j] = 0.0f;
          }
        }
      }
    }
    __syncwarp();  // tile i is scored and tile i - 1 read
    if (++since_flush == T::kFlushTiles) {
      flush();
      since_flush = 0;
    }
  }
  if (any) {  // the products of the last tile, in the slot before `slot`
#pragma unroll
    for (int step = 0; step < T::kSteps; ++step) mma_step(step, slot ^ 1);
  }
  flush();

  // Block reduction in a fixed order: each warp writes its float64 sums as
  // a 16 x 20 matrix M (columns 16 + t: the z sums of lane t's depths), then
  // the block adds the warps' contributions in warp order.
  __syncthreads();  // every tile is read
  double* mat = reinterpret_cast<double*>(smem);
  double* mine = mat + warp * 16 * kMatCols;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i < 2 ? gid : gid + 8;
    const int j = 2 * t + (i & 1);
    mine[r * kMatCols + j] = e0[i];
    if (!T::kStacked) mine[r * kMatCols + j + 8] = e1[i];
  }
  if (!T::kOnesRow) {
    mine[gid * kMatCols + 16 + t] = eza;
    if (!T::kStacked) mine[(gid + 8) * kMatCols + 16 + t] = ezb;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    // Sum p: z_k sums (p < K, row j = K is the ones row) or z_j z_k for
    // upper-triangle entry p - K, row-major.
    int j = K, k = p;
    if (p >= K) {
      int rest = p - K;
      j = 0;
      while (rest >= K - j) rest -= K - j, ++j;
      k = j + rest;
    }
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      const double* mw = mat + w * 16 * kMatCols;
      if (p < K && !T::kOnesRow) {  // each set's row of column k, each lane t
#pragma unroll
        for (int set = 0; set < T::kSets; ++set) {
#pragma unroll
          for (int q = 0; q < 4; ++q) s += mw[(T::kRows * set + k) * kMatCols + 16 + q];
        }
      } else if (T::kStacked) {
        // Up to K = 8: hi.hi + lo.hi + its transpose, each set in turn.
#pragma unroll
        for (int set = 0; set < T::kSets; ++set) {
          const int x = T::kRows * set + j, y = T::kRows * set + k;
          s += mw[x * kMatCols + y] + mw[(8 + x) * kMatCols + y] + mw[(8 + y) * kMatCols + x];
        }
      } else if (p < K) {
        s += mw[K * kMatCols + k];
      } else if (j == k) {
        s += mw[j * kMatCols + j];
      } else {
        s += 0.5 * (mw[j * kMatCols + k] + mw[k * kMatCols + j]);
      }
    }
    partials[static_cast<int64_t>(blockIdx.x) * P + p] = s;
  }
}

template <int K>
int blocks_for(int64_t n, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr_stats<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<K>::kSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, corr_stats<K>, kThreads,
                                                        Tile<K>::kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n / 4 + 2 + Tile<K>::kGroups - 1) / Tile<K>::kGroups + 1;  // at most
  const int64_t wanted = (tiles + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = static_cast<int>(wanted < resident ? (wanted > 0 ? wanted : 1) : resident);
  return 0;
}

template <int K>
int resident(int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      corr_stats<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<K>::kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, corr_stats<K>, kThreads,
                                                        Tile<K>::kSmemBytes);
  }
  return static_cast<int>(err);
}

template <int K>
int launch(const int* columns, uint32_t k0, uint32_t k1, int64_t start, int64_t n,
           double* partials, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      corr_stats<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<K>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Columns cols = {};
  for (int k = 0; k < K; ++k) cols.c[k] = static_cast<uint32_t>(columns[k]);
  corr_stats<K><<<blocks, kThreads, Tile<K>::kSmemBytes, stream>>>(
      cols, sampling_math::philox_keys(k0, k1), start, n, partials);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn<K>(args...) for K in 1..kMaxCorr; cudaErrorInvalidValue otherwise.
#define CORR_STATS_DISPATCH(K_VALUE, CALL)             \
  switch (K_VALUE) {                                   \
    case 1: return CALL(1);                            \
    case 2: return CALL(2);                            \
    case 3: return CALL(3);                            \
    case 4: return CALL(4);                            \
    case 5: return CALL(5);                            \
    case 6: return CALL(6);                            \
    case 7: return CALL(7);                            \
    case 8: return CALL(8);                            \
    case 9: return CALL(9);                            \
    case 10: return CALL(10);                          \
    case 11: return CALL(11);                          \
    case 12: return CALL(12);                          \
    case 13: return CALL(13);                          \
    case 14: return CALL(14);                          \
    case 15: return CALL(15);                          \
    case 16: return CALL(16);                          \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// The number of blocks corr_stats_launch will use for K columns and n
// samples (one row of partials each): enough to fill the card once.
extern "C" int corr_stats_grid(int k, int64_t n, int* blocks) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
#define CORR_STATS_GRID(KK) blocks_for<KK>(n, blocks)
  CORR_STATS_DISPATCH(k, CORR_STATS_GRID)
#undef CORR_STATS_GRID
}

// Blocks of the kernel for K columns that one SM holds at once.
extern "C" int corr_stats_blocks_per_sm(int k, int* per_sm) {
#define CORR_STATS_RESIDENT(KK) resident<KK>(per_sm)
  CORR_STATS_DISPATCH(k, CORR_STATS_RESIDENT)
#undef CORR_STATS_RESIDENT
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `columns` is int32 (k,) in host memory, `partials` float64
// (blocks, k + k(k+1)/2), `blocks` as corr_stats_grid gave it; the sums
// run over samples start..start+n-1.
extern "C" int corr_stats_launch(const void* columns, int k, uint32_t seed0, uint32_t seed1,
                                 int64_t start, int64_t n, void* partials, int blocks,
                                 void* stream) {
  if (n <= 0 || start < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define CORR_STATS_LAUNCH(KK)                                                          \
  launch<KK>(static_cast<const int*>(columns), seed0, seed1, start, n,                 \
             static_cast<double*>(partials), blocks, static_cast<cudaStream_t>(stream))
  CORR_STATS_DISPATCH(k, CORR_STATS_LAUNCH)
#undef CORR_STATS_LAUNCH
}
