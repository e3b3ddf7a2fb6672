// sampling_math.cuh: device functions shared by the port's kernels.
//
// The generated graph megakernels (engine/cuda_exec.py::generate) and
// corr_stats.cu both include this file, so the correlation-statistics pass
// and the main pass compute the normal scores z = ndtri_fast(u) from the
// same Philox bits with the same code.  Each
// function transcribes its plain PyTorch twin: ops/philox.py
// (philox4x32_10, bits_to_open_unit) and ops/special.py (erfinv_f32,
// ndtri_fast, ndtr_fast).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sampling_math {

// All four words of Philox4x32-10 (Salmon et al., SC'11) at counter
// (g mod 2^32, g >> 32, column, 0) under key (k0, k1).  g is a group of
// four consecutive samples: word w (.x, .y, .z, .w) is the draw of sample
// 4 g + w in that column, so one call serves four samples and no word is
// thrown away.
__device__ __forceinline__ uint4 philox_group(uint64_t g, uint32_t column, uint32_t k0,
                                              uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(g);
  uint32_t c1 = static_cast<uint32_t>(g >> 32);
  uint32_t c2 = column;
  uint32_t c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The ten round keys of Philox4x32-10 under key (k0, k1), for a kernel
// that takes them as a launch parameter: its rounds then read each key
// from constant memory instead of holding twenty in registers.
struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

inline PhiloxKeys philox_keys(uint32_t k0, uint32_t k1) {
  PhiloxKeys keys;
  for (int r = 0; r < 10; ++r) {
    keys.k0[r] = k0;
    keys.k1[r] = k1;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return keys;
}

// philox_group with the round keys given.
__device__ __forceinline__ uint4 philox_group(uint64_t g, uint32_t column,
                                              const PhiloxKeys& keys) {
  uint32_t c0 = static_cast<uint32_t>(g);
  uint32_t c1 = static_cast<uint32_t>(g >> 32);
  uint32_t c2 = column;
  uint32_t c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ keys.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ keys.k1[r];
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The top 23 bits in the mantissa of 1.0f, minus 1, clamped to
// [2^-24, 1 - 2^-24].
__device__ __forceinline__ float bits_to_open_unit(uint32_t bits) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float tiny = 5.9604644775390625e-08f;  // 2^-24
  return fminf(fmaxf(u, tiny), 1.0f - tiny);
}

// sqrt.approx.f32: the hardware's square root without sqrtf's slow path
// for denormals (a call and a convergence barrier in the middle of
// otherwise straight-line code).
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The Giles (2012) erfinv polynomials: the central branch (fit for w < 5)
// in w - 2.5, the tail branch (fit up to w ~ 16.6) in ws = sqrt(w) - 3.
__device__ __forceinline__ float giles_central(float w) {
  const float wc = w - 2.5f;
  float p1 = 2.81022636e-08f;
  p1 = 3.43273939e-07f + p1 * wc;
  p1 = -3.5233877e-06f + p1 * wc;
  p1 = -4.39150654e-06f + p1 * wc;
  p1 = 0.00021858087f + p1 * wc;
  p1 = -0.00125372503f + p1 * wc;
  p1 = -0.00417768164f + p1 * wc;
  p1 = 0.246640727f + p1 * wc;
  p1 = 1.50140941f + p1 * wc;
  return p1;
}

__device__ __forceinline__ float giles_tail(float ws) {
  float p2 = -0.000200214257f;
  p2 = 0.000100950558f + p2 * ws;
  p2 = 0.00134934322f + p2 * ws;
  p2 = -0.00367342844f + p2 * ws;
  p2 = 0.00573950773f + p2 * ws;
  p2 = -0.0076224613f + p2 * ws;
  p2 = 0.00943887047f + p2 * ws;
  p2 = 1.00167406f + p2 * ws;
  p2 = 2.83297682f + p2 * ws;
  return p2;
}

// Giles (2012) single-precision inverse error function.  The logarithm
// and the square root are the hardware's approximations (__logf: 2^-21.4
// absolute on [0.5, 2], 2 ulps elsewhere; sqrt.approx): the argument of
// the log is clamped to a normal float, its error moves w by under 2e-7
// where the polynomial's slope is below 1, and the square root feeds the
// tail polynomial alone.  On an H100 at n = 1e8 the largest difference
// from the plain twin stayed where libm's logf and sqrtf left it
// (chip_smoke.py prints it), and the kernels ran 1.4 to 1.8 times faster:
// libm's slow paths are calls behind convergence barriers, which also
// keep the four lanes' chains from interleaving.
__device__ __forceinline__ float erfinv_f32(float x) {
  float w = -__logf(fmaxf((1.0f - x) * (1.0f + x), 1e-37f));
  w = fminf(w, 16.64f);
  const float p1 = giles_central(w);
  const float p2 = giles_tail(sqrt_approx(w) - 3.0f);
  return (w < 5.0f ? p1 : p2) * x;
}

__device__ __forceinline__ float ndtri_fast(float q) {
  return 1.4142135623730951f * erfinv_f32(2.0f * q - 1.0f);
}

// Standard-normal CDF, Abramowitz & Stegun 7.1.26 (1.5e-7 absolute by
// design, so its division is the fast one); the lower tail is computed
// directly, never as 1 - (something near 1).
__device__ __forceinline__ float ndtr_fast(float x) {
  const float z = fabsf(x) * 0.70710678118654752f;
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * z);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float tail = 0.5f * poly * expf(-z * z);
  return x >= 0.0f ? 1.0f - tail : tail;
}

// ops/qmc.py::clamp_open_unit in float32 (NaN stays NaN, as torch.clamp).
__device__ __forceinline__ float clamp_open_unit(float q) {
  const float tiny = 5.9604644775390625e-08f;  // 2^-24
  return isnan(q) ? q : fminf(fmaxf(q, tiny), 1.0f - tiny);
}

}  // namespace sampling_math
