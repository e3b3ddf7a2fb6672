// graph_ops.cuh: the hand-written bodies of the graph megakernel's ops.
//
// engine/cuda_exec.py::generate writes one kernel per graph structure:
// this file, ppf_ops.cuh (the families' inverse CDFs), special_ops.cuh,
// sampling_math.cuh, a grid-stride loop over groups of four samples, and
// one line per tape row and lane that calls into here.  Each function
// transcribes its plain PyTorch twin: ops/ppf.py (the score forms of the
// inverse CDFs), models/graph.py (the transforms with jax.numpy
// semantics on the CPU, float32, int32 and bool).  Parameters arrive as
// values, so a node-valued parameter costs nothing extra.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"

namespace graph_ops {

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

// int32 arithmetic wraps around 2^32, as XLA's and PyTorch's CPU code do.
// Signed overflow is undefined in C++, so it is computed on the unsigned
// bits.
__device__ __forceinline__ int wrap_i32(uint32_t x) { return static_cast<int>(x); }

__device__ __forceinline__ int add_i32(int a, int b) {
  return wrap_i32(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int sub_i32(int a, int b) {
  return wrap_i32(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int mul_i32(int a, int b) {
  return wrap_i32(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int neg_i32(int a) { return wrap_i32(0u - static_cast<uint32_t>(a)); }

// |-2^31| wraps to -2^31.
__device__ __forceinline__ int abs_i32(int a) { return a < 0 ? neg_i32(a) : a; }

__device__ __forceinline__ int sign_i32(int a) { return (a > 0) - (a < 0); }

__device__ __forceinline__ int max_i32(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int min_i32(int a, int b) { return a < b ? a : b; }

// Integer floor division and modulo with the divisor's sign (jnp.floor_divide,
// jnp.mod).  A zero divisor gives XLA's values: a // 0 is -1 when a is 0
// and -2 otherwise, a % 0 is 0.  -2^31 // -1 wraps to -2^31, and a % -1
// is 0; the division proper is never asked for those.
__device__ __forceinline__ int floor_divide_i32(int a, int b) {
  if (b == 0) return a == 0 ? -1 : -2;
  if (b == -1) return neg_i32(a);
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod_i32(int a, int b) {
  if (b == 0 || b == -1) return 0;
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// torch.pow on int32 (ATen's powi): squaring, wrapping around 2^32; a
// negative exponent gives 1 for a base of 1, +-1 for -1, else 0.  (jnp
// gives other values there: ROADMAP C, R7.)
__device__ __forceinline__ int pow_i32(int a, int b) {
  if (b < 0) return a == 1 ? 1 : (a == -1 ? ((b & 1) ? -1 : 1) : 0);
  uint32_t base = static_cast<uint32_t>(a), result = 1u;
  for (uint32_t e = static_cast<uint32_t>(b); e != 0u; e >>= 1) {
    if (e & 1u) result *= base;
    base *= base;
  }
  return wrap_i32(result);
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
