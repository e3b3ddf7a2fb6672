// special_ops.cuh: the special functions of the megakernel's family ops.
//
// Each function transcribes its plain PyTorch twin in ops/special.py under
// kernel_safe_special (the functions the TPU kernel lowers): the wide-range
// normal quantile, expm1_safe, the Lanczos log-gamma, the series and
// continued-fraction incomplete gamma, the 40-pair continued-fraction
// incomplete beta, and the two safeguarded Newton inverses.  Where the
// twin evaluates both branches of a select (the series and the continued
// fraction; the direct and the flipped beta fraction) these evaluate only
// the branch the lane takes: the value is the same.  The log-gammas that
// the twin recomputes at every Newton trip are computed once per call
// here; they are the same values.
//
// The Newton inverses are __noinline__: every row of a generated kernel is
// written once per lane, and four inlined copies of a 40-trip loop around
// a 40-pair continued fraction would multiply the code and its build time.
// A lane leaves its loop at its own convergence (or at the trip cap) and
// keeps the value it had before that trip's step: the twin's absorbing
// per-lane freeze, so a lane's trips and value never depend on the others.
//
// Division and libm calls are IEEE (no fast-math flags); the compiler may
// contract a multiply and an add into an FMA where the twin rounds twice.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"

namespace special_ops {

constexpr float kTiny = 1e-30f;

// exp(x) - 1: a 7-term Taylor branch below |x| < 0.25, else expf(x) - 1.
__device__ __forceinline__ float expm1_safe(float x) {
  if (fabsf(x) < 0.25f) {
    return x * (1.0f +
                x * (0.5f +
                     x * (0.16666666666666666f +
                          x * (0.041666666666666664f +
                               x * (0.008333333333333333f +
                                    x * (0.001388888888888889f + x / 5040.0f))))));
  }
  return expf(x) - 1.0f;
}

// Standard-normal quantile accurate for q down to 1e-37: the Giles
// branches in w = -log(4 q (1 - q)) computed from q directly, and past the
// fit (w > 16.3) three fixed-point steps of the erfc asymptotic series.
// libm's logf and sqrtf here (the fast path's __logf is for the draws).
__device__ __forceinline__ float ndtri_fast_wide(float q) {
  const float tail_c = fmaxf(fminf(q, 1.0f - q), 1e-37f);
  const float w = -(logf(tail_c) + log1pf(-tail_c) + 1.3862944f);
  const float sign = q >= 0.5f ? 1.0f : -1.0f;
  float erfinv;
  if (w > 16.3f) {
    float y = sqrtf(w);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float inv2 = 1.0f / (2.0f * y * y);
      const float series = log1pf(-inv2 + 3.0f * inv2 * inv2);
      y = sqrtf(fmaxf(w + 0.6931472f - 0.5723649f - logf(y) + series, 1.0f));
    }
    erfinv = y * sign;
  } else {
    const float x = 2.0f * q - 1.0f;
    erfinv = (w < 5.0f ? sampling_math::giles_central(w)
                       : sampling_math::giles_tail(sqrtf(fminf(w, 16.64f)) - 3.0f)) *
             x;
  }
  return 1.4142135623730951f * erfinv;
}

// Log-gamma for x > 0, Lanczos (g = 7, 9 terms).
__device__ __forceinline__ float lgamma_kernel(float x) {
  const float z = x - 1.0f;
  float acc = 0.99999999999980993f;
  acc = acc + 676.5203681218851f / (z + 1.0f);
  acc = acc + -1259.1392167224028f / (z + 2.0f);
  acc = acc + 771.32342877765313f / (z + 3.0f);
  acc = acc + -176.61502916214059f / (z + 4.0f);
  acc = acc + 12.507343278686905f / (z + 5.0f);
  acc = acc + -0.13857109526572012f / (z + 6.0f);
  acc = acc + 9.9843695780195716e-6f / (z + 7.0f);
  acc = acc + 1.5056327351493116e-7f / (z + 8.0f);
  const float t = z + 7.5f;
  return 0.9189385332046727f + (z + 0.5f) * logf(t) - t + logf(acc);
}

__device__ __forceinline__ float lentz_guard(float v) { return fabsf(v) < kTiny ? kTiny : v; }

// Regularized lower incomplete gamma P(a, x); lgam_a = lgamma_kernel(a).
// 48 series terms for x < a + 1, else 48 steps of Lentz's continued
// fraction for Q.  Sized for a in (0, ~30].
__device__ __forceinline__ float gammainc_kernel(float a, float x, float lgam_a) {
  const float xs = fmaxf(x, kTiny);
  const float log_pre = a * logf(xs) - xs - lgam_a;
  float p;
  if (xs < a + 1.0f) {
    float term = 1.0f / a;
    float total = term;
    for (int n = 0; n < 48; ++n) {
      term = term * xs / (a + 1.0f + static_cast<float>(n));
      total = total + term;
    }
    p = total * expf(log_pre);
  } else {
    float c = 1e30f;
    float d = 1.0f / lentz_guard(xs + 1.0f - a);
    float h = d;
    for (int i = 0; i < 48; ++i) {
      const float i1 = static_cast<float>(i) + 1.0f;
      const float an = -i1 * (i1 - a);
      const float bb = xs + 1.0f - a + 2.0f * i1;
      d = 1.0f / lentz_guard(bb + an * d);
      c = lentz_guard(bb + an / c);
      h = h * d * c;
    }
    p = 1.0f - expf(log_pre) * h;
  }
  if (x <= 0.0f) p = 0.0f;
  return fminf(fmaxf(p, 0.0f), 1.0f);
}

// Continued fraction of the incomplete beta (Lentz, 40 even/odd pairs).
__device__ __forceinline__ float betacf(float a, float b, float x) {
  const float qab = a + b;
  const float qap = a + 1.0f;
  const float qam = a - 1.0f;
  float c = 1.0f;
  float d = 1.0f / lentz_guard(1.0f - qab * x / qap);
  float h = d;
  for (int m1 = 0; m1 < 40; ++m1) {
    const float m = static_cast<float>(m1) + 1.0f;
    const float two_m = 2.0f * m;
    float aa = m * (b - m) * x / ((qam + two_m) * (a + two_m));
    d = 1.0f / lentz_guard(1.0f + aa * d);
    c = lentz_guard(1.0f + aa / c);
    h = h * d * c;
    aa = -(a + m) * (qab + m) * x / ((a + two_m) * (qap + two_m));
    d = 1.0f / lentz_guard(1.0f + aa * d);
    c = lentz_guard(1.0f + aa / c);
    h = h * d * c;
  }
  return h;
}

// Regularized incomplete beta I_x(a, b); lgab = lgamma(a + b) - lgamma(a)
// - lgamma(b) (Lanczos), the twin's order.  Sized for a, b in (0, ~30].
__device__ __forceinline__ float betainc_kernel(float a, float b, float x, float lgab) {
  const float xc = fminf(fmaxf(x, kTiny), 0.9999999f);
  const float bt = expf(lgab + a * logf(xc) + b * log1pf(-xc));
  float p = xc < (a + 1.0f) / (a + b + 2.0f) ? bt * betacf(a, b, xc) / a
                                             : 1.0f - bt * betacf(b, a, 1.0f - xc) / b;
  if (x <= 0.0f) p = 0.0f;
  if (x >= 1.0f) p = 1.0f;
  return fminf(fmaxf(p, 0.0f), 1.0f);
}

// Inverse of P(a, x) in p: Wilson-Hilferty guess (the power law x^a /
// Gamma(a + 1) for a < 0.5), then at most 26 Newton trips in log x, each
// step clipped to [-2, 2]; a lane freezes where |step| <= 3e-5 and
// |P - p| <= 1e-4.
__device__ __noinline__ float gammaincinv(float a, float p) {
  const float p_c = fminf(fmaxf(p, kTiny), 0.9999999f);
  const float s = 1.0f / (9.0f * a);
  const float z = ndtri_fast_wide(p_c);
  const float base = 1.0f - s + z * sqrtf(s);
  float guess = a * (base * base * base);
  if (a < 0.5f || guess <= 0.0f) {
    guess = expf((logf(fmaxf(p_c, kTiny)) + lgamma_kernel(a + 1.0f)) / a);
  }
  float log_x = logf(fmaxf(guess, kTiny));
  const float lgam = lgamma_kernel(a);
  for (int i = 0; i < 26; ++i) {
    const float x = expf(log_x);
    const float f = gammainc_kernel(a, x, lgam) - p_c;
    float step = f * expf(-(a * log_x - x - lgam));
    step = fminf(fmaxf(step, -2.0f), 2.0f);
    if (fabsf(step) <= 3e-5f && fabsf(f) <= 1e-4f) break;
    log_x = log_x - step;
  }
  float x = expf(log_x);
  if (p <= 0.0f) x = 0.0f;
  if (p >= 1.0f) x = INFINITY;
  return x;
}

// Inverse of I_x(a, b) in p: Abramowitz & Stegun 26.5.22 guess (the
// power-law tail inverse for a <= 1 or b <= 1), then at most 40
// bisection-safeguarded Newton trips inside the bracket [lo, hi]; a lane
// freezes where its relative move is <= 3e-5 and |I - p| <= 1e-4.
__device__ __noinline__ float betaincinv(float a, float b, float p) {
  const float p_c = fminf(fmaxf(p, 1e-7f), 0.9999999f);
  const float y = ndtri_fast_wide(p_c);
  const float la = 1.0f / (2.0f * a - 1.0f);
  const float lb = 1.0f / (2.0f * b - 1.0f);
  const float h = 2.0f / (la + lb);
  const float w = y * sqrtf(h + (y * y - 3.0f) / 6.0f) / h -
                  (lb - la) * ((y * y - 3.0f) / 6.0f + 0.8333333333333334f - 2.0f / (3.0f * h));
  float guess = a / (a + b * expf(2.0f * w));
  const float lg_a = lgamma_kernel(a), lg_b = lgamma_kernel(b), lg_ab = lgamma_kernel(a + b);
  const float lbeta = lg_a + lg_b - lg_ab;
  if (a <= 1.0f || b <= 1.0f || !isfinite(guess)) {
    guess = expf((logf(fmaxf(p_c, kTiny)) + lbeta + logf(a)) / a);
  }
  float x = fminf(fmaxf(guess, 1e-6f), 0.999999f);
  const float lgab = lg_ab - lg_a - lg_b;
  float lo = 0.0f, hi = 1.0f;
  for (int i = 0; i < 40; ++i) {
    const float f = betainc_kernel(a, b, x, lgab) - p_c;
    if (f < 0.0f) lo = x;
    if (f > 0.0f) hi = x;
    const float log_pdf = (a - 1.0f) * logf(x) + (b - 1.0f) * log1pf(-x) - lbeta;
    const float newton = x - f * expf(-log_pdf);
    const bool bad = !isfinite(newton) || newton <= lo || newton >= hi;
    const float x_new = bad ? 0.5f * (lo + hi) : newton;
    if (fabsf(x_new - x) / fmaxf(x, kTiny) <= 3e-5f && fabsf(f) <= 1e-4f) break;
    x = x_new;
  }
  if (p <= 0.0f) x = 0.0f;
  if (p >= 1.0f) x = 1.0f;
  return x;
}

}  // namespace special_ops
