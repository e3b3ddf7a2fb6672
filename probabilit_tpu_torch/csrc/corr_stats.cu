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
// reduces the per-block partials in float64 and solves the K x K recolour
// transform (A, b) that the megakernel's RECOLOR rows apply.
//
// Unlike the TPU kernel, it draws exactly the columns plan.col_of[v] of
// the correlated variables (the counter carries the column), so the main
// kernel needs no reordered draw.
//
// What bounds it on an H100: ALU work.  Per group of four samples it does K
// Philox calls (10 rounds of two 32x32->64-bit multiplies and two 3-input
// XORs, ~43 integer instructions, all four words used) and 4 K Giles ndtri
// evaluations (a log, a sqrt, two 9-term polynomials, ~50 flops), then 4 P
// multiply-adds; it reads nothing and writes 4 * P bytes per block.
//
// What the design does about it: a thread owns whole groups, so each Philox
// call yields four scores and the four samples' dependent chains (ten
// rounds, two Horner polynomials) interleave in the pipes.  Every sum
// lives in a register of its thread for the whole loop (K is a template
// parameter, so all indices are compile-time and nothing is spilled by
// indexing); the only communication is one warp-shuffle and shared-memory
// reduction per block at the end.  No atomics: the block sums in a fixed
// order and writes one row of partials, so a seed gives the same sums on
// every run of a card.  The first and the last group of a launch may be
// partial (start or n no multiple of 4): their samples outside
// [start, start + n) score 0 and add nothing.  A group holds 4 K scores
// beside the P sums, so the largest K spill; chip_smoke.py prints ptxas's
// registers and spill bytes for each K.

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"

namespace {

// Must equal MAX_CORR_K in engine/cuda_exec.py.
constexpr int kMaxCorr = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int K>
__global__ void __launch_bounds__(kThreads)
    corr_stats(const int* __restrict__ columns, uint32_t k0, uint32_t k1, int64_t start,
               int64_t n, float* __restrict__ partials) {
  static_assert(K >= 1 && K <= kMaxCorr, "1..kMaxCorr correlated columns");
  constexpr int P = K + K * (K + 1) / 2;
  uint32_t col[K];
#pragma unroll
  for (int k = 0; k < K; ++k) col[k] = static_cast<uint32_t>(columns[k]);

  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;

  // Groups g_first .. g_end - 1 cover samples start .. start + n - 1.
  const uint64_t first = static_cast<uint64_t>(start);
  const uint64_t end = first + static_cast<uint64_t>(n);
  const uint64_t g_end = ((end - 1) >> 2) + 1;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t g = (first >> 2) + static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < g_end; g += stride) {
    const uint64_t i0 = g << 2;
    const bool whole = i0 >= first && i0 + 3 < end;
    float z[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint4 w = sampling_math::philox_group(g, col[k], k0, k1);
      const uint32_t bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int lane = 0; lane < 4; ++lane) {
        z[k][lane] = sampling_math::ndtri_fast(sampling_math::bits_to_open_unit(bits[lane]));
      }
    }
    if (!whole) {
#pragma unroll
      for (int lane = 0; lane < 4; ++lane) {
        if (i0 + lane < first || i0 + lane >= end) {
#pragma unroll
          for (int k = 0; k < K; ++k) z[k][lane] = 0.0f;
        }
      }
    }
    // One multiply-add a term, the group's four samples in index order:
    // the P sums are independent chains, so the pipes stay full.
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += z[k][lane];
#pragma unroll
      for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int k = j; k < K; ++k) {
          acc[K + j * K - j * (j - 1) / 2 + (k - j)] += z[j][lane] * z[k][lane];
        }
      }
    }
  }

  // Block reduction in a fixed order: shuffles within each warp, then the
  // warps' sums in warp order.
  __shared__ float s_warp[kWarps][P];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v = acc[p];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, offset);
    if (lane == 0) s_warp[warp][p] = v;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_warp[w][p];
    partials[static_cast<int64_t>(blockIdx.x) * P + p] = s;
  }
}

template <int K>
int blocks_for(int64_t n, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, corr_stats<K>, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t groups = n / 4 + 2;  // at most: a partial group at either end
  const int64_t wanted = (groups + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = static_cast<int>(wanted < resident ? (wanted > 0 ? wanted : 1) : resident);
  return 0;
}

template <int K>
int launch(const int* columns, uint32_t k0, uint32_t k1, int64_t start, int64_t n,
           float* partials, int blocks, cudaStream_t stream) {
  corr_stats<K><<<blocks, kThreads, 0, stream>>>(columns, k0, k1, start, n, partials);
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

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `columns` is int32 (k,) on the device, `partials` float32
// (blocks, k + k(k+1)/2), `blocks` as corr_stats_grid gave it; the sums
// run over samples start..start+n-1.
extern "C" int corr_stats_launch(const void* columns, int k, uint32_t seed0, uint32_t seed1,
                                 int64_t start, int64_t n, void* partials, int blocks,
                                 void* stream) {
  if (n <= 0 || start < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define CORR_STATS_LAUNCH(KK)                                                          \
  launch<KK>(static_cast<const int*>(columns), seed0, seed1, start, n,                 \
             static_cast<float*>(partials), blocks, static_cast<cudaStream_t>(stream))
  CORR_STATS_DISPATCH(k, CORR_STATS_LAUNCH)
#undef CORR_STATS_LAUNCH
}
