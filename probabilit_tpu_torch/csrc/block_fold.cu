// block_fold.cu: a streamed block's float64 moments, merged into the
// estimate's carry, in one launch.
//
// Replaces no TPU kernel.  The JAX package's fold
// (probabilit_tpu/engine/streaming.py::_block_moments and _merge) is jnp
// code that XLA fuses under jit into one pass over the block.  The port's
// plain twin, engine/streaming.py::_block_moments + _merge, runs the same
// arithmetic eagerly: about 40 launches a block, each reading or writing
// a float64 copy of it (about 1.3 GB of traffic for 2^24 samples).
// engine/cuda_exec.py::block_fold launches this kernel in its place for a
// block on the card inside streaming._estimate_carry.
//
// What it computes: over the samples i < cnt of the float32 block x that
// it accepts (every one, or under where= those whose condition y[i] is
// nonzero), their count n, mean, central sums M2 (with `moments` also M3
// and M4), min, max and whether all are finite; with a control y (read as
// float64), y's mean, M2y and the cross sum Cxy.  It merges them into the
// float64 carry buffer (the fields of Field below) in place, with the
// formulas of _merge (Chan; Pébay for M3 and M4).  A rejected sample is
// never read into any statistic, and a block that accepts nothing is a
// no-op merge.
//
// What bounds it on an H100: reading the block, 4 bytes a sample: 64 MiB
// for 2^24 samples, 0.020 ms at 3.35 TB/s (80 MiB and 0.025 ms with a
// float32 y).  Its float64 arithmetic, about a dozen operations and one
// conversion a sample, is a few microseconds at the card's FP64 rate.
//
// What the design does about it:
// * One pass over the block, one launch.  A resident wave of 256-thread
//   CTAs strides over tiles of 4096 samples; a thread loads 16 samples of
//   a tile in four 16-byte loads (neighbouring threads on neighbouring
//   addresses) and keeps them in registers as float64.
// * Per thread and tile, an exact two-pass over those registers: the
//   mean, then the central sums.  Every sample is accumulated in float64.
//   min and max are taken in float32 (exact on float32 samples) with PTX's
//   NaN-propagating min/max, as torch.amin and amax propagate NaN.  The
//   float64 sum of at most 16 float32 samples is finite exactly when every
//   one of them is, so the non-finite test costs nothing a sample.
// * A tile's statistics are merged into the thread's (Chan, Pébay), the
//   lanes' by shuffles, the warps' through shared memory, each in a fixed
//   order.  Each CTA writes its statistics to scratch; the last CTA to
//   finish (an integer ticket behind a fence) merges them in a fixed
//   order, merges the block into the carry and resets the ticket for the
//   next launch.  No floating-point atomics: a repeat gives the same bits.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;                  // 16-byte loads of x a thread makes per tile
constexpr int kItems = 4 * kChunks;         // samples a thread holds per tile
constexpr int kChunkStride = 4 * kThreads;  // samples between a thread's chunks
constexpr int kTile = kItems * kThreads;    // samples a CTA folds per tile
constexpr int kMaxBlocksPerSm = 2048 / kThreads;

// The kinds of y; must equal engine/cuda_exec.py's _FOLD_Y_KINDS.
enum YKind : int { kNoY = 0, kF32 = 1, kF64 = 2, kU8 = 3, kI32 = 4 };

// The fields of the carry buffer, and the rows of the CTAs' partials; must
// equal the order of engine/streaming.py's _PACKED_FIELDS.
enum Field : int { fN, fMean, fM2, fMin, fMax, fFinite, fMy, fM2y, fCxy, fM3, fM4, kFields };

struct Stats {
  double n, mean, m2, m3, m4, my, m2y, cxy, lo, hi;
  int finite;
};

__device__ __forceinline__ Stats empty_stats() {
  Stats s;
  s.n = s.mean = s.m2 = s.m3 = s.m4 = s.my = s.m2y = s.cxy = 0.0;
  s.lo = CUDART_INF;
  s.hi = -CUDART_INF;
  s.finite = 1;
  return s;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.minimum / torch.maximum: NaN if either is NaN.
__device__ __forceinline__ double min_nan(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmin(a, b);
}

__device__ __forceinline__ double max_nan(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmax(a, b);
}

// Chan's pairwise merge (Pébay for M3 and M4) of two sets' statistics.
// An empty side is the identity: its min and max are +-inf, it is finite.
template <bool kControl, bool kMoments>
__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  if (b.n == 0.0) return a;
  if (a.n == 0.0) return b;
  Stats r;
  const double nn = a.n + b.n;
  const double inv = 1.0 / nn;
  const double delta = b.mean - a.mean;
  const double w = a.n * b.n * inv;
  r.n = nn;
  r.mean = a.mean + delta * b.n * inv;
  r.m2 = a.m2 + b.m2 + delta * delta * w;
  if constexpr (kMoments) {
    const double d2 = delta * delta;
    r.m4 = a.m4 + b.m4 + d2 * d2 * w * (a.n * a.n - a.n * b.n + b.n * b.n) * inv * inv +
           6.0 * d2 * (a.n * a.n * b.m2 + b.n * b.n * a.m2) * inv * inv +
           4.0 * delta * (a.n * b.m3 - b.n * a.m3) * inv;
    r.m3 = a.m3 + b.m3 + d2 * delta * w * (a.n - b.n) * inv +
           3.0 * delta * (a.n * b.m2 - b.n * a.m2) * inv;
  } else {
    r.m3 = r.m4 = 0.0;
  }
  if constexpr (kControl) {
    const double dy = b.my - a.my;
    r.my = a.my + dy * b.n * inv;
    r.m2y = a.m2y + b.m2y + dy * dy * w;
    r.cxy = a.cxy + b.cxy + delta * dy * w;
  } else {
    r.my = r.m2y = r.cxy = 0.0;
  }
  r.lo = min_nan(a.lo, b.lo);
  r.hi = max_nan(a.hi, b.hi);
  r.finite = a.finite & b.finite;
  return r;
}

template <bool kControl, bool kMoments>
__device__ __forceinline__ Stats shfl_down(const Stats& s, int offset) {
  constexpr unsigned kAll = 0xffffffffu;
  Stats o;
  o.n = __shfl_down_sync(kAll, s.n, offset);
  o.mean = __shfl_down_sync(kAll, s.mean, offset);
  o.m2 = __shfl_down_sync(kAll, s.m2, offset);
  if constexpr (kMoments) {
    o.m3 = __shfl_down_sync(kAll, s.m3, offset);
    o.m4 = __shfl_down_sync(kAll, s.m4, offset);
  } else {
    o.m3 = o.m4 = 0.0;
  }
  if constexpr (kControl) {
    o.my = __shfl_down_sync(kAll, s.my, offset);
    o.m2y = __shfl_down_sync(kAll, s.m2y, offset);
    o.cxy = __shfl_down_sync(kAll, s.cxy, offset);
  } else {
    o.my = o.m2y = o.cxy = 0.0;
  }
  o.lo = __shfl_down_sync(kAll, s.lo, offset);
  o.hi = __shfl_down_sync(kAll, s.hi, offset);
  o.finite = __shfl_down_sync(kAll, s.finite, offset);
  return o;
}

// The CTA's statistics, in thread 0: lanes by shuffles, then warps in
// warp order.  Every thread calls it; `shared` holds kWarps entries.
template <bool kControl, bool kMoments>
__device__ Stats cta_merge(Stats s, Stats* shared) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    s = merge<kControl, kMoments>(s, shfl_down<kControl, kMoments>(s, offset));
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? shared[lane] : empty_stats();
    for (int offset = kWarps / 2; offset > 0; offset >>= 1) {
      s = merge<kControl, kMoments>(s, shfl_down<kControl, kMoments>(s, offset));
    }
  }
  return s;
}

// Samples i .. i + 3 of x; `in` says which lie below cnt (they are 0
// elsewhere).  A chunk wholly below cnt is one 16-byte load.
__device__ __forceinline__ void load_x(const float* x, int64_t i, int64_t cnt, float v[4],
                                       bool in[4]) {
  if (i + 4 <= cnt) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(x + i));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    in[0] = in[1] = in[2] = in[3] = true;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      in[j] = i + j < cnt;
      v[j] = in[j] ? x[i + j] : 0.0f;
    }
  }
}

// Entries i .. i + 3 of y as float64 (0 at or past cnt).
template <int kY>
__device__ __forceinline__ void load_y(const void* y, int64_t i, int64_t cnt, double v[4]) {
  const bool whole = i + 4 <= cnt;
  if constexpr (kY == kF32) {
    const float* p = static_cast<const float*>(y) + i;
    if (whole) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < cnt ? p[j] : 0.0f;
  } else if constexpr (kY == kF64) {
    const double* p = static_cast<const double*>(y) + i;
    if (whole) {
      const double2 a = __ldg(reinterpret_cast<const double2*>(p));
      const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < cnt ? p[j] : 0.0;
  } else if constexpr (kY == kU8) {
    const uint8_t* p = static_cast<const uint8_t*>(y) + i;
    if (whole) {
      const uchar4 q = __ldg(reinterpret_cast<const uchar4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < cnt ? p[j] : 0;
  } else if constexpr (kY == kI32) {
    const int* p = static_cast<const int*>(y) + i;
    if (whole) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < cnt ? p[j] : 0;
  }
}

// _merge of a block's statistics into the carry, the same formulas in
// the same order (nn clamped to 1 under where=).
template <bool kWhere, bool kMoments>
__device__ void merge_into_carry(double* c, const Stats& b) {
  const double n_prev = c[fN], mean = c[fMean], m2 = c[fM2], my = c[fMy];
  const double delta = b.mean - mean;
  const double delta_y = b.my - my;
  const double nn = n_prev + b.n;
  const double nn_div = kWhere ? fmax(nn, 1.0) : nn;
  const double w = n_prev * b.n / nn_div;
  if constexpr (kMoments) {
    const double m3 = c[fM3], m4 = c[fM4];
    const double d2 = delta * delta;
    const double nn2 = nn_div * nn_div;
    c[fM4] = m4 + b.m4 +
             (d2 * d2 * w * (n_prev * n_prev - n_prev * b.n + b.n * b.n) / nn2 +
              6.0 * d2 * (n_prev * n_prev * b.m2 + b.n * b.n * m2) / nn2 +
              4.0 * delta * (n_prev * b.m3 - b.n * m3) / nn_div);
    c[fM3] = m3 + b.m3 +
             (d2 * delta * w * (n_prev - b.n) / nn_div +
              3.0 * delta * (n_prev * b.m2 - b.n * m2) / nn_div);
  }
  c[fN] = nn;
  c[fMean] = mean + delta * b.n / nn_div;
  c[fM2] = m2 + b.m2 + delta * delta * w;
  c[fMin] = min_nan(c[fMin], b.lo);
  c[fMax] = max_nan(c[fMax], b.hi);
  c[fFinite] = (c[fFinite] != 0.0 && b.finite) ? 1.0 : 0.0;
  c[fMy] = my + delta_y * b.n / nn_div;
  c[fM2y] = c[fM2y] + b.m2y + delta_y * delta_y * w;
  c[fCxy] = c[fCxy] + b.cxy + delta * delta_y * w;
}

// `partials` is float64 (kFields, capacity), a CTA's statistics in its
// column; `ticket` is 0 before a launch and after it.
template <int kY, bool kWhere, bool kMoments>
__global__ void __launch_bounds__(kThreads) block_fold_kernel(
    const float* __restrict__ x, const void* __restrict__ y, int64_t cnt,
    double* __restrict__ carry, double* __restrict__ partials, int capacity,
    unsigned int* __restrict__ ticket) {
  constexpr bool kControl = kY != kNoY && !kWhere;
  __shared__ Stats shared[kWarps];
  __shared__ bool last;
  Stats acc = empty_stats();
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  const int64_t tiles = (cnt + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t first = tile * kTile + 4 * static_cast<int64_t>(threadIdx.x);
    float xf[kItems];
    bool ok[kItems];
    double yd[kY == kNoY ? 1 : kItems];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      load_x(x, first + c * kChunkStride, cnt, &xf[4 * c], &ok[4 * c]);
      if constexpr (kY != kNoY) load_y<kY>(y, first + c * kChunkStride, cnt, &yd[4 * c]);
    }
    if constexpr (kWhere) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) ok[k] = ok[k] && yd[k] != 0.0;
    }
    // Pass 1: the count, the sums, min and max of the accepted samples.
    double xd[kItems];
    double sx = 0.0, sy = 0.0;
    int n = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      xd[k] = ok[k] ? static_cast<double>(xf[k]) : 0.0;
      sx += xd[k];
      n += ok[k];
      lo = min_nan(lo, ok[k] ? xf[k] : CUDART_INF_F);
      hi = max_nan(hi, ok[k] ? xf[k] : -CUDART_INF_F);
      if constexpr (kControl) sy += yd[k];
    }
    if (n == 0) continue;
    // Pass 2: the central sums about the tile's means.
    Stats t;
    t.n = n;
    t.mean = n == kItems ? sx * (1.0 / kItems) : sx / n;
    t.my = kControl ? (n == kItems ? sy * (1.0 / kItems) : sy / n) : 0.0;
    t.m2 = t.m3 = t.m4 = t.m2y = t.cxy = 0.0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const double d = ok[k] ? xd[k] - t.mean : 0.0;
      if constexpr (kMoments) {
        const double d2 = d * d;
        t.m2 += d2;
        t.m3 = fma(d2, d, t.m3);
        t.m4 = fma(d2, d2, t.m4);
      } else {
        t.m2 = fma(d, d, t.m2);
      }
      if constexpr (kControl) {
        const double dy = ok[k] ? yd[k] - t.my : 0.0;
        t.m2y = fma(dy, dy, t.m2y);
        t.cxy = fma(d, dy, t.cxy);
      }
    }
    t.lo = CUDART_INF;
    t.hi = -CUDART_INF;
    t.finite = isfinite(sx);
    acc = merge<kControl, kMoments>(acc, t);
  }
  acc.lo = lo;
  acc.hi = hi;
  acc = cta_merge<kControl, kMoments>(acc, shared);
  if (threadIdx.x == 0) {
    double* col = partials + blockIdx.x;
    col[fN * capacity] = acc.n;
    col[fMean * capacity] = acc.mean;
    col[fM2 * capacity] = acc.m2;
    col[fMin * capacity] = acc.lo;
    col[fMax * capacity] = acc.hi;
    col[fFinite * capacity] = acc.finite;
    col[fMy * capacity] = acc.my;
    col[fM2y * capacity] = acc.m2y;
    col[fCxy * capacity] = acc.cxy;
    col[fM3 * capacity] = acc.m3;
    col[fM4 * capacity] = acc.m4;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last CTA: every partial, in a fixed order, then into the carry.
  __threadfence();
  Stats s = empty_stats();
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const double* col = partials + b;
    Stats p;
    p.n = __ldcg(col + fN * capacity);
    p.mean = __ldcg(col + fMean * capacity);
    p.m2 = __ldcg(col + fM2 * capacity);
    p.lo = __ldcg(col + fMin * capacity);
    p.hi = __ldcg(col + fMax * capacity);
    p.finite = __ldcg(col + fFinite * capacity) != 0.0;
    p.my = __ldcg(col + fMy * capacity);
    p.m2y = __ldcg(col + fM2y * capacity);
    p.cxy = __ldcg(col + fCxy * capacity);
    p.m3 = __ldcg(col + fM3 * capacity);
    p.m4 = __ldcg(col + fM4 * capacity);
    s = merge<kControl, kMoments>(s, p);
  }
  s = cta_merge<kControl, kMoments>(s, shared);
  if (threadIdx.x == 0) {
    merge_into_carry<kWhere, kMoments>(carry, s);
    *ticket = 0u;
  }
}

template <int kY, bool kWhere, bool kMoments>
int launch(const float* x, const void* y, int64_t cnt, double* carry, double* partials,
           int capacity, unsigned int* ticket, cudaStream_t stream) {
  static int per_sm = 0;  // resident CTAs an SM holds, per instantiation
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, block_fold_kernel<kY, kWhere, kMoments>, kThreads, 0);
  }
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (cnt + kTile - 1) / kTile;
  int64_t grid = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > tiles) grid = tiles;
  if (grid > capacity) grid = capacity;
  block_fold_kernel<kY, kWhere, kMoments><<<static_cast<int>(grid), kThreads, 0, stream>>>(
      x, y, cnt, carry, partials, capacity, ticket);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The columns of partials a launch may use on the current card: as many
// CTAs as it can hold at once.
extern "C" int block_fold_capacity(int* blocks) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * kMaxBlocksPerSm;
  return 0;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `x` is
// float32, `y` of `y_kind` (YKind) or null, both 16-byte aligned with at
// least cnt entries; `carry` is float64 (kFields,), folded in place;
// `partials` float64 (kFields, capacity); `ticket` a zeroed uint32.  With
// `where`, y is the condition (nonzero accepts), else the control.
extern "C" int block_fold_launch(const void* x, const void* y, int y_kind, int where,
                                 int moments, int64_t cnt, void* carry, void* partials,
                                 int capacity, void* ticket, void* stream) {
  if (cnt <= 0 || capacity <= 0 || (y_kind == kNoY) != (y == nullptr) ||
      (where && y_kind == kNoY) || (!where && (y_kind == kU8 || y_kind == kI32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xs = static_cast<const float*>(x);
  double* c = static_cast<double*>(carry);
  double* p = static_cast<double*>(partials);
  unsigned int* t = static_cast<unsigned int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLOCK_FOLD(KY, KW)                                              \
  return moments ? launch<KY, KW, true>(xs, y, cnt, c, p, capacity, t, s) \
                 : launch<KY, KW, false>(xs, y, cnt, c, p, capacity, t, s)
  if (where) {
    switch (y_kind) {
      case kF32: BLOCK_FOLD(kF32, true);
      case kF64: BLOCK_FOLD(kF64, true);
      case kU8: BLOCK_FOLD(kU8, true);
      case kI32: BLOCK_FOLD(kI32, true);
      default: break;
    }
  } else {
    switch (y_kind) {
      case kNoY: BLOCK_FOLD(kNoY, false);
      case kF32: BLOCK_FOLD(kF32, false);
      case kF64: BLOCK_FOLD(kF64, false);
      default: break;
    }
  }
#undef BLOCK_FOLD
  return static_cast<int>(cudaErrorInvalidValue);
}
