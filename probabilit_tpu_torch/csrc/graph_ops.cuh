// graph_ops.cuh: the hand-written bodies of the graph megakernel's ops.
//
// engine/cuda_exec.py::generate writes one kernel per graph structure:
// this file, ppf_ops.cuh (the families' inverse CDFs), special_ops.cuh,
// sampling_math.cuh, a grid-stride loop over groups of four samples, and
// one line per tape row and lane that calls into here.  Each function
// transcribes its plain PyTorch twin: ops/ppf.py (the score forms of the
// inverse CDFs), models/graph.py (the transforms with jax.numpy
// semantics).  Parameters arrive as values, so a node-valued
// parameter costs nothing extra.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"

namespace graph_ops {

// Comparisons and logical ops give 1.0f or 0.0f: the tape is float32.
__device__ __forceinline__ float truth(bool x) { return x ? 1.0f : 0.0f; }

// torch.floor_divide on floats (ATen's div_floor_floating).
__device__ __forceinline__ float floor_divide(float a, float b) {
  if (b == 0.0f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div -= 1.0f;
  if (div == 0.0f) return copysignf(0.0f, a / b);
  float floordiv = floorf(div);
  if (div - floordiv > 0.5f) floordiv += 1.0f;
  return floordiv;
}

// jnp.mod / torch.remainder: the result takes the divisor's sign.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

// torch.maximum / torch.minimum propagate NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// jnp.isclose / torch.isclose with rtol = 1e-5, atol = 1e-8.
__device__ __forceinline__ bool isclose(float a, float b) {
  if (a == b) return true;
  const float diff = fabsf(a - b);
  return isfinite(diff) && diff <= 1e-8f + fabsf(1e-5f * b);
}

// jnp.sign: NaN stays NaN, zeros keep their value.
__device__ __forceinline__ float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// ppf(ndtr(y)) in closed form for the score-linear families: y is the
// recoloured normal score.
__device__ __forceinline__ float score_norm(float y, float loc, float scale) {
  return loc + scale * y;
}

__device__ __forceinline__ float score_lognorm(float y, float s, float loc, float scale) {
  return loc + scale * expf(s * y);
}

// A recoloured score as a quantile for the variable's own ppf.
__device__ __forceinline__ float ndtr_open(float y) {
  return sampling_math::clamp_open_unit(sampling_math::ndtr_fast(y));
}

// Writes four consecutive samples of one kept row: `row` is the row's
// first element, r0 the row index of the first of the four (negative or
// beyond n - 4 in the partial first and last group of a launch whose start
// or n is no multiple of 4).  `vec` says that every group of the launch is
// whole and 16-byte aligned (start and n multiples of 4): one float4 store,
// so a warp writes 512 contiguous bytes.  Otherwise scalar stores, masked.
// `bad` collects non-finite stored values.
__device__ __forceinline__ void store_group(float* __restrict__ row, int64_t r0, int64_t n,
                                            bool vec, float x0, float x1, float x2, float x3,
                                            bool& bad) {
  if (vec) {
    *reinterpret_cast<float4*>(row + r0) = make_float4(x0, x1, x2, x3);
    bad |= !(isfinite(x0) && isfinite(x1) && isfinite(x2) && isfinite(x3));
    return;
  }
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int lane = 0; lane < 4; ++lane) {
    const int64_t r = r0 + lane;
    if (r >= 0 && r < n) {
      row[r] = x[lane];
      bad |= !isfinite(x[lane]);
    }
  }
}

}  // namespace graph_ops
