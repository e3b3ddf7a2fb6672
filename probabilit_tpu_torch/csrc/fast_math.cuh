// fast_math.cuh: the call-free float32 functions of the closed-form family
// branches (ppf_ops.cuh).
//
// Every function here is straight-line code on the hardware's
// approximations (PTX lg2.approx, ex2.approx, rcp.approx and sqrt.approx,
// each one MUFU instruction) and FMA polynomials: no libm call, no IEEE
// division, no local memory, so the four lanes of a thread interleave
// their chains.  CUDA's libm (logf, log1pf, expf, powf, tanf, sinf, sqrtf
// and IEEE division) carries slow paths behind convergence barriers, and
// tanf and sinf a Payne-Hanek reduction in local memory, for arguments the
// families never pass.  ops/fast_math.py transcribes each function in
// PyTorch (torch.log2 and torch.exp2 standing in for the MUFU ops), and
// tools/fast_math_fit.py derives the polynomials' coefficients.
//
// Error bounds are over the arguments the families pass, in float32 ulps
// of the result unless stated otherwise; they add the PTX approximations'
// documented errors (lg2.approx: 2^-22 absolute on log2 x for x in
// [0.5, 2], 2 ulps elsewhere; ex2.approx: 2 ulps; rcp.approx: 1 ulp) to
// the polynomials' own (measured by tools/fast_math_fit.py).  The twins
// the kernel is held to (ops/ppf.py) use correctly rounded libm functions;
// these stay within the twin tolerance that chip_smoke.py checks per family
// (1e-4 of a node's largest value).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"

namespace fast_math {

constexpr float kLn2 = 0.6931472f;
constexpr float kLn2Hi = 0.69314575f;   // 0x3F317200: e * kLn2Hi is exact for |e| < 2^8
constexpr float kLn2Lo = 1.4286068e-06f;  // ln 2 - kLn2Hi
constexpr float kLog2e = 1.442695f;
constexpr float kQuarterPi = 0.7853982f;
constexpr float kHalfPiHi = 1.5707964f;  // the float nearest pi/2
constexpr float kHalfPiLo = -4.371139e-08f;  // pi/2 - kHalfPiHi

// ---- The hardware's approximations ----------------------------------------

// The .ftz forms flush a denormal argument or result to zero (lg2 of a
// denormal is -inf): the families' arguments are normal floats, the twin's
// clamps (1e-37, 1e-30, 2^-126) keep them so, and a result below 2^-126
// is zero to the tolerance.  lg2_full keeps denormals, for log_fast's
// special values.
__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float lg2_full(float x) {
  float r;
  asm("lg2.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

using sampling_math::sqrt_approx;

// a / b: the reciprocal's quotient and one correction from its exact
// residual; within 1 ulp (IEEE division rounds correctly, this almost
// always).  b finite and nonzero (b = 0 gives NaN where IEEE gives inf).
// A division by a shape parameter is a multiplication by its rcp_fast,
// which the compiler hoists out of the sample loop (within 2 ulps).
__device__ __forceinline__ float div_fast(float a, float b) {
  const float r = rcp_approx(b);
  const float q = a * r;
  return fmaf(fmaf(-b, q, a), r, q);
}

__device__ __forceinline__ float rcp_fast(float b) { return div_fast(1.0f, b); }

// ---- Logarithms -------------------------------------------------------------

// log(1 + f) for f in [-1/3, 1/3]: f + f^2 P(f), P of degree 8 minimax for
// the relative error (2^-27.5 in exact arithmetic; 1.5 ulps in float32).
__device__ __forceinline__ float log1p_reduced(float f) {
  float p = -0.12949032f;
  p = fmaf(p, f, 0.14004828f);
  p = fmaf(p, f, -0.1216714f);
  p = fmaf(p, f, 0.14001147f);
  p = fmaf(p, f, -0.16682306f);
  p = fmaf(p, f, 0.20010749f);
  p = fmaf(p, f, -0.24999717f);
  p = fmaf(p, f, 0.3333321f);
  p = fmaf(p, f, -0.5f);
  return fmaf(f * f, p, f);
}

// x = 2^e m with m in [2/3, 4/3), for positive normal finite x: then
// m - 1 is exact and log x = e ln 2 + log1p(m - 1).
__device__ __forceinline__ float reduce_log(float x, int& e) {
  const int ix = __float_as_int(x);
  e = (ix - 0x3F2AAAAB) >> 23;  // 0x3F2AAAAB: 2/3
  return __int_as_float(ix - (e << 23));
}

// e ln 2 + log1p(f), e ln 2 in two parts (e kLn2Hi is exact).
__device__ __forceinline__ float log_from(int e, float f) {
  const float fe = __int_as_float(e + 0x4B400000) - 12582912.0f;  // float(e), no I2F
  return fmaf(fe, kLn2Hi, fmaf(fe, kLn2Lo, log1p_reduced(f)));
}

// Whether x is a positive normal finite float.
__device__ __forceinline__ bool positive_normal(float x) {
  return static_cast<unsigned>(__float_as_int(x) - 0x00800000) < 0x7F000000u;
}

// log x.  For x in [2/3, 4/3) it is the polynomial alone, on the exact
// x - 1: relative accuracy near 1, where lg2.approx has only absolute
// accuracy.  Anything but a positive normal finite x (0, a denormal, inf,
// NaN, a negative) takes lg2.approx, which gives libm's special values.
// Within 2 ulps.
__device__ __forceinline__ float log_fast(float x) {
  int e;
  const float m = reduce_log(x, e);
  float r = log_from(e, m - 1.0f);
  if (!positive_normal(x)) r = lg2_full(x) * kLn2;
  return r;
}

// log(1 + x) for -1 < x < 2^127, relative accuracy at every x: u = 1 + x
// rounded is reduced as log_fast reduces it, and what the sum lost, x - (u
// - 1) (exact), is folded back into the reduced argument scaled by 2^-e:
// log1p((m - 1) + (x - (u - 1)) 2^-e).  For |x| < 1/3 that argument is x
// itself.  Within 2 ulps.
__device__ __forceinline__ float log1p_fast(float x) {
  const float u = 1.0f + x;
  int e;
  const float m = reduce_log(u, e);
  const float scale = __int_as_float(0x3F800000 - (e << 23));  // 2^-e
  float r = log_from(e, fmaf(x - (u - 1.0f), scale, m - 1.0f));
  if (!positive_normal(u)) r = lg2_full(u) * kLn2;
  return r;
}

// log x by lg2.approx, for normal x: 2^-22 ln 2 absolute for x in
// [0.5, 2], 2 ulps elsewhere.  Where a family's value needs no relative
// accuracy of the log near 1 (the log is added to something, or its sign
// near 0 is free) it takes this, 2 instructions, for log_fast's 20.
__device__ __forceinline__ float log_mufu(float x) { return lg2_approx(x) * kLn2; }

// ---- Exponentials and powers ------------------------------------------------

// e^x = ex2.approx(x log2 e): the rounding of the product and of log2 e,
// below 8e-8 |x| relative, beside ex2.approx's 2 ulps (7e-6 relative at
// the overflow threshold, far inside the twin tolerance).  inf past
// x = 88.72, 0 below x = -87.34 (ftz), and e^-inf = 0, e^inf = inf,
// e^NaN = NaN as libm gives them.
__device__ __forceinline__ float exp_fast(float x) { return ex2_approx(x * kLog2e); }

// e^x - 1 as the twin's expm1_safe (ops/special.py) computes it: the
// 7-term Taylor polynomial for |x| < 0.25, else e^x - 1.  Both sides are
// computed and one selected.
__device__ __forceinline__ float expm1_fast(float x) {
  const float taylor =
      x * (1.0f +
           x * (0.5f +
                x * (0.16666666666666666f +
                     x * (0.041666666666666664f +
                          x * (0.008333333333333333f +
                               x * (0.001388888888888889f + x * 1.984126984126984e-4f))))));
  const float big = exp_fast(x) - 1.0f;
  return fabsf(x) < 0.25f ? taylor : big;
}

// x^y = 2^(y log2 x) for x >= 0 (0^y = 0 for y > 0, inf for y < 0; x^0 = 1
// for x > 0): lg2.approx and ex2.approx.  Relative error about
// (2 + 2 |y log2 x|) ulps for x outside [0.5, 2], and within |y| 2^-22 ln 2
// more for x in [0.5, 2] (where lg2.approx's error is absolute).  The
// families' bases are never negative; a denormal base is its own value
// (the twin's clamps keep them normal where it matters).
__device__ __forceinline__ float pow_fast(float x, float y) {
  return ex2_approx(y * lg2_approx(x));
}

// ---- Trigonometric functions ------------------------------------------------

// tan r for |r| <= pi/4: r + r^3 P(r^2), P of degree 5 minimax for the
// relative error (2^-25.8 exact; 1.5 ulps in float32).
__device__ __forceinline__ float tan_reduced(float r) {
  const float z = r * r;
  float p = 0.009385742f;
  p = fmaf(p, z, 0.0031193472f);
  p = fmaf(p, z, 0.024430493f);
  p = fmaf(p, z, 0.053411182f);
  p = fmaf(p, z, 0.13338801f);
  p = fmaf(p, z, 0.33333156f);
  return fmaf(r * z, p, r);
}

// tan x, or with cot its reciprocal, for |x| up to the float nearest
// pi/2.  Past pi/4 the complement d = pi/2 - |x| is taken as
// (kHalfPiHi - |x|) + kHalfPiLo, the subtraction exact (Sterbenz), so d
// keeps its relative accuracy at the pole, where x's own float decides the
// value: tan x = 1 / tan d.  Cody-Waite's two-term reduction alone; no
// Payne-Hanek path, since the arguments never leave (-pi/2, pi/2] by more
// than an ulp.  Within 3 ulps of tan of the float x.
__device__ __forceinline__ float tan_or_cot(float x, bool cot) {
  const float ax = fabsf(x);
  const bool far = ax > kQuarterPi;
  const float d = (kHalfPiHi - ax) + kHalfPiLo;
  const float t = tan_reduced(far ? d : ax);
  const float v = far != cot ? rcp_fast(t) : t;  // d < 0 past the pole: v < 0
  return x < 0.0f ? -v : v;
}

__device__ __forceinline__ float tan_fast(float x) { return tan_or_cot(x, false); }

__device__ __forceinline__ float cot_fast(float x) { return tan_or_cot(x, true); }

// sin x for |x| <= pi/2 (a little beyond: the float nearest pi/2):
// x + x^3 P(x^2), P of degree 3 minimax for the relative error (2^-27
// exact; 2 ulps in float32).
__device__ __forceinline__ float sin_fast(float x) {
  const float z = x * x;
  float p = 2.60578e-06f;
  p = fmaf(p, z, -0.00019809602f);
  p = fmaf(p, z, 0.0083330665f);
  p = fmaf(p, z, -0.1666666f);
  return fmaf(x * z, p, x);
}

// ---- The normal distribution ------------------------------------------------

// Standard-normal CDF: sampling_math::ndtr_fast (Abramowitz & Stegun
// 7.1.26, 1.5e-7 absolute by design) with exp_fast for libm's expf.
__device__ __forceinline__ float ndtr_mufu(float x) {
  const float z = fabsf(x) * 0.70710678118654752f;
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * z);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float tail = 0.5f * poly * exp_fast(-z * z);
  return x >= 0.0f ? 1.0f - tail : tail;
}

// Standard-normal quantile accurate for q down to 1e-37: the formula of
// special_ops::ndtri_fast_wide (which the Newton tier keeps) on these
// functions.  w = -log(4 t (1 - t)), t = min(q, 1 - q), is one lg2.approx
// of t (1 - t): 3e-7 absolute, where the Giles polynomials' slope is below
// 1; both Giles branches are computed and one selected.  Past their fit (w
// > 16.3, q below 2.4e-8: no draw reaches it, only a shape that squeezes
// the tail) three fixed-point steps of the erfc asymptotic series on
// MUFU approximations (there w is 16 or more and every log is far from
// 0), behind a branch that warps take together.
__device__ __forceinline__ float ndtri_wide_fast(float q) {
  const float tail = fmaxf(fminf(q, 1.0f - q), 1e-37f);
  const float w = -fmaf(lg2_approx(tail * (1.0f - tail)), kLn2, 1.3862944f);
  const float p1 = sampling_math::giles_central(w);
  const float p2 = sampling_math::giles_tail(sqrt_approx(fminf(w, 16.64f)) - 3.0f);
  float erfinv = (w < 5.0f ? p1 : p2) * (2.0f * q - 1.0f);
  if (w > 16.3f) {
    float y = sqrt_approx(w);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float inv2 = rcp_approx(2.0f * y * y);
      const float series = log_mufu(1.0f + (-inv2 + 3.0f * inv2 * inv2));
      y = sqrt_approx(fmaxf(w + 0.6931472f - 0.5723649f - log_mufu(y) + series, 1.0f));
    }
    erfinv = q >= 0.5f ? y : -y;
  }
  return 1.4142135623730951f * erfinv;
}

// ---- IEEE division without its slow path ------------------------------------

// 1 / d in double: rcp.approx.ftz.f64 and two Newton steps (full double
// precision for normal d).
__device__ __forceinline__ double rcp_double(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  r = fma(r, fma(-d, r, 1.0), r);
  return fma(r, fma(-d, r, 1.0), r);
}

// a / b for floats a, b, rounded once to float32 from a double quotient
// within 2^-52 of a / b: IEEE's correctly rounded quotient (an exact
// quotient stays exact), where a discrete family's step turns on it.
__device__ __forceinline__ float div_rounded(float a, float b) {
  return static_cast<float>(static_cast<double>(a) * rcp_double(static_cast<double>(b)));
}

}  // namespace fast_math
