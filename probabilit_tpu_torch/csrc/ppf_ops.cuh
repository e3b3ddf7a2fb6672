// ppf_ops.cuh: the family branches of the graph megakernel.
//
// Replaces the inverse CDFs that probabilit_tpu/engine/pallas_exec.py's
// kernel body traces from probabilit_tpu/ops/ppf.py for the closed-form
// families of its whitelist (_SAFE_FAMILIES); the families it solves by
// Newton on the incomplete gamma and beta functions are newton_ops.cuh's.
// Each ppf_<family> transcribes its plain PyTorch twin in ops/ppf.py at
// the default loc (and scale): it returns the family's standard variate
// from q and the shape parameters, and the tape's next row applies loc +
// scale * x (the discrete families: k + loc).  A tape row holds four
// operands; truncnorm, burr and their kind need five with loc and scale,
// truncweibull_min six.  Where the twin's formula is loc - scale * y or
// loc + scale / y, the standard variate is -y or 1 / y.
//
// Where the twin evaluates every branch of a select, these evaluate the
// one the lane takes.  ndtri_fast is the draws' fast quantile
// (sampling_math.cuh: __logf and sqrt.approx); ndtr_fast takes
// __fdividef.  Both stay inside the twin tolerance that chip_smoke.py
// checks per family.  Draws are open-unit (q in [2^-24, 1 - 2^-24]), where
// every branch below is finite.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"
#include "special_ops.cuh"

namespace ppf_ops {

using sampling_math::ndtr_fast;
using sampling_math::ndtri_fast;
using special_ops::expm1_safe;
using special_ops::ndtri_fast_wide;

constexpr float kPi = 3.141592653589793f;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kSqrt2Pi = 2.5066282746310002f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// ---- Closed forms -------------------------------------------------------

__device__ __forceinline__ float ppf_uniform(float q) { return q; }

__device__ __forceinline__ float ppf_norm(float q) { return ndtri_fast(q); }

__device__ __forceinline__ float ppf_expon(float q) { return -log1pf(-q); }

__device__ __forceinline__ float ppf_lognorm(float q, float s) { return expf(s * ndtri_fast(q)); }

// The square roots are the hardware's (sampling_math::sqrt_approx).
__device__ __forceinline__ float ppf_triang(float q, float c) {
  const float left = sampling_math::sqrt_approx(q * c);
  const float right = 1.0f - sampling_math::sqrt_approx((1.0f - q) * (1.0f - c));
  return q <= c ? left : right;
}

__device__ __forceinline__ float ppf_truncnorm(float q, float a, float b) {
  float x;
  if (a + b > 0.0f) {  // the survival form keeps windows in the upper tail
    const float sa = ndtr_fast(-a), sb = ndtr_fast(-b);
    x = -ndtri_fast_wide(sa + q * (sb - sa));
  } else {
    const float fa = ndtr_fast(a), fb = ndtr_fast(b);
    x = ndtri_fast_wide(fa + q * (fb - fa));
  }
  return fminf(fmaxf(x, a), b);
}

__device__ __forceinline__ float ppf_cauchy(float q) { return tanf(kPi * (q - 0.5f)); }

__device__ __forceinline__ float ppf_laplace(float q) {
  return q < 0.5f ? logf(2.0f * q) : -logf(2.0f * (1.0f - q));
}

__device__ __forceinline__ float ppf_logistic(float q) { return logf(q) - log1pf(-q); }

__device__ __forceinline__ float ppf_gumbel_r(float q) { return -logf(-logf(q)); }

__device__ __forceinline__ float ppf_gumbel_l(float q) { return logf(-log1pf(-q)); }

__device__ __forceinline__ float ppf_rayleigh(float q) { return sqrtf(-2.0f * log1pf(-q)); }

__device__ __forceinline__ float ppf_halfnorm(float q) {
  return -ndtri_fast_wide(0.5f * (1.0f - q));
}

__device__ __forceinline__ float ppf_pareto(float q, float b) {
  return powf(1.0f - q, -1.0f / b);
}

__device__ __forceinline__ float ppf_weibull_min(float q, float c) {
  return powf(-log1pf(-q), 1.0f / c);
}

__device__ __forceinline__ float ppf_weibull_max(float q, float c) {
  return -powf(-logf(q), 1.0f / c);
}

__device__ __forceinline__ float ppf_powerlaw(float q, float a) { return powf(q, 1.0f / a); }

__device__ __forceinline__ float ppf_loguniform(float q, float a, float b) {
  return expf(logf(a) + q * (logf(b) - logf(a)));
}

__device__ __forceinline__ float ppf_reciprocal(float q, float a, float b) {
  return ppf_loguniform(q, a, b);
}

__device__ __forceinline__ float ppf_arcsine(float q) {
  const float s = sinf(kHalfPi * q);
  return s * s;
}

__device__ __forceinline__ float ppf_hypsecant(float q) {
  const float mag = logf(tanf(kHalfPi * fminf(q, 1.0f - q)));
  return q < 0.5f ? mag : -mag;
}

__device__ __forceinline__ float ppf_fisk(float q, float c) {
  return powf(q / (1.0f - q), 1.0f / c);
}

__device__ __forceinline__ float ppf_genpareto(float q, float c) {
  if (fabsf(c) < 1e-9f) return -log1pf(-q);
  return expm1_safe(-c * log1pf(-q)) / c;
}

__device__ __forceinline__ float ppf_genextreme(float q, float c) {
  const float lq = -logf(q);
  if (fabsf(c) < 1e-9f) return -logf(lq);
  return -expm1_safe(c * logf(lq)) / c;
}

__device__ __forceinline__ float ppf_alpha(float q, float a) {
  // CDF = ndtr(a - 1/x) / ndtr(a); past q = 0.999 the first-order tail form.
  const float na = ndtr_fast(a);
  if (q > 0.999f) {
    const float D = na * (1.0f - q) / (kInvSqrt2Pi * expf(-0.5f * a * a));
    return 1.0f / (D * (1.0f - 0.5f * a * D));
  }
  return 1.0f / (a - ndtri_fast_wide(q * na));
}

__device__ __forceinline__ float ppf_bradford(float q, float c) {
  return expm1_safe(q * log1pf(c)) / c;
}

__device__ __forceinline__ float ppf_burr(float q, float c, float d) {
  return powf(expm1_safe(-log1pf(q - 1.0f) / d), -1.0f / c);
}

__device__ __forceinline__ float ppf_burr12(float q, float c, float d) {
  return powf(expm1_safe(-log1pf(-q) / d), 1.0f / c);
}

__device__ __forceinline__ float ppf_dweibull(float q, float c) {
  if (q < 0.5f) return -powf(-logf(fmaxf(2.0f * q, 1e-12f)), 1.0f / c);
  return powf(-logf(fmaxf(2.0f * (1.0f - q), 1e-12f)), 1.0f / c);
}

__device__ __forceinline__ float ppf_exponpow(float q, float b) {
  return powf(log1pf(-log1pf(-q)), 1.0f / b);
}

__device__ __forceinline__ float ppf_exponweib(float q, float a, float c) {
  const float t = -expm1_safe(log1pf(q - 1.0f) / a);
  return powf(-logf(t), 1.0f / c);
}

__device__ __forceinline__ float ppf_fatiguelife(float q, float c) {
  const float t = c * ndtri_fast(q);
  const float r = t + sqrtf(t * t + 4.0f);
  return 0.25f * (r * r);
}

__device__ __forceinline__ float ppf_genhalflogistic(float q, float c) {
  const float t = (1.0f - q) / (1.0f + q);
  return (1.0f - powf(t, c)) / c;
}

__device__ __forceinline__ float ppf_genlogistic(float q, float c) {
  return -logf(expm1_safe(-log1pf(q - 1.0f) / c));
}

__device__ __forceinline__ float ppf_gibrat(float q) { return expf(ndtri_fast(q)); }

__device__ __forceinline__ float ppf_gompertz(float q, float c) {
  return log1pf(-log1pf(-q) / c);
}

__device__ __forceinline__ float ppf_halfcauchy(float q) {
  return 1.0f / tanf(kHalfPi * (1.0f - q));
}

__device__ __forceinline__ float ppf_halflogistic(float q) { return log1pf(q) - log1pf(-q); }

__device__ __forceinline__ float ppf_invweibull(float q, float c) {
  return powf(-log1pf(q - 1.0f), -1.0f / c);
}

__device__ __forceinline__ float ppf_johnsonsb(float q, float a, float b) {
  const float z = (ndtri_fast(q) - a) / b;
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float ppf_johnsonsu(float q, float a, float b) {
  const float ez = expf((ndtri_fast(q) - a) / b);
  return 0.5f * (ez - 1.0f / ez);
}

__device__ __forceinline__ float ppf_kappa3(float q, float a) {
  const float z = a * log1pf(q - 1.0f);
  const float ratio = expf(z) / (-expm1_safe(z));
  return powf(a * ratio, 1.0f / a);
}

__device__ __forceinline__ float ppf_laplace_asymmetric(float q, float kappa) {
  const float k2 = kappa * kappa;
  if (q < k2 / (1.0f + k2)) return kappa * logf(fmaxf(q * (1.0f + k2) / k2, 1e-30f));
  return -logf(fmaxf((1.0f - q) * (1.0f + k2), 1e-30f)) / kappa;
}

__device__ __forceinline__ float ppf_levy(float q) {
  const float z = ndtri_fast_wide(0.5f * q);
  return 1.0f / (z * z);
}

__device__ __forceinline__ float ppf_levy_l(float q) {
  const float z = ndtri_fast_wide(0.5f * (1.0f - q));
  return -(1.0f / (z * z));
}

__device__ __forceinline__ float ppf_loglaplace(float q, float c) {
  if (q < 0.5f) return powf(fmaxf(2.0f * q, 1e-30f), 1.0f / c);
  return powf(fmaxf(2.0f * (1.0f - q), 1e-30f), -1.0f / c);
}

__device__ __forceinline__ float ppf_lomax(float q, float c) {
  return expm1_safe(-log1pf(-q) / c);
}

__device__ __forceinline__ float ppf_mielke(float q, float k, float s) {
  const float z = (s / k) * log1pf(q - 1.0f);
  const float ratio = expf(z) / (-expm1_safe(z));
  return powf(ratio, 1.0f / s);
}

__device__ __forceinline__ float ppf_moyal(float q) {
  return -2.0f * logf(-ndtri_fast_wide(0.5f * q));
}

// ndtri((1 - q)^(1/c)), through -ndtri(1 - w) for q < 1/2.
__device__ __forceinline__ float powernorm_score(float q, float c) {
  if (q < 0.5f) {
    const float one_minus_w = -expm1_safe(log1pf(-q) / c);
    return -ndtri_fast_wide(fmaxf(one_minus_w, 1.1754943508222875e-38f));
  }
  return ndtri_fast_wide(powf(1.0f - q, 1.0f / c));
}

__device__ __forceinline__ float ppf_powerlognorm(float q, float c, float s) {
  return expf(-s * powernorm_score(q, c));
}

__device__ __forceinline__ float ppf_powernorm(float q, float c) {
  return -powernorm_score(q, c);
}

__device__ __forceinline__ float ppf_trapezoid(float q, float c, float d) {
  const float h = 2.0f / (1.0f + d - c);
  if (q < 0.5f * h * c) return sqrtf(fmaxf(2.0f * c * q / h, 0.0f));
  if (q < h * (d - 0.5f * c)) return q / h + 0.5f * c;
  return 1.0f - sqrtf(fmaxf(2.0f * (1.0f - d) * (1.0f - q) / h, 0.0f));
}

__device__ __forceinline__ float ppf_truncexpon(float q, float b) {
  return -log1pf(q * expm1_safe(-b));
}

__device__ __forceinline__ float ppf_truncpareto(float q, float b, float c) {
  return powf(1.0f - q * (1.0f - powf(c, -b)), -1.0f / b);
}

__device__ __forceinline__ float ppf_truncweibull_min(float q, float c, float a, float b) {
  const float sa = expf(-powf(a, c));
  const float sb = expf(-powf(b, c));
  return powf(-logf(sa - q * (sa - sb)), 1.0f / c);
}

__device__ __forceinline__ float ppf_tukeylambda(float q, float lam) {
  if (fabsf(lam) < 1e-7f) return logf(q) - log1pf(-q);
  return (powf(q, lam) - powf(1.0f - q, lam)) / lam;
}

__device__ __forceinline__ float ppf_skewcauchy(float q, float a) {
  const float wl = 1.0f - a, wu = 1.0f + a;
  const float f0 = 0.5f * wl;
  if (q < f0) {
    if (q < 0.5f * f0) return -wl / tanf(kPi * q / wl);
    return wl * tanf(kPi * (q - f0) / wl);
  }
  if (q > f0 + 0.5f * wu * 0.5f) return wu / tanf(kPi * (1.0f - q) / wu);
  return wu * tanf(kPi * (q - f0) / wu);
}

__device__ __forceinline__ float ppf_kappa4(float q, float h, float k) {
  const float logq = logf(q);
  const float t = h == 0.0f ? -logq : -expm1_safe(h * logq) / h;
  const float logt = logf(t);
  return k == 0.0f ? -logt : -expm1_safe(k * logt) / k;
}

__device__ __forceinline__ float ppf_crystalball(float q, float beta, float m) {
  const float b2h = 0.5f * beta * beta;
  const float C = m / (beta * (m - 1.0f)) * expf(-b2h);
  const float D = kSqrt2Pi * ndtr_fast(beta);
  const float logN = -logf(C + D);
  if (q < expf(logN) * C) {  // the power-law tail, inverted in log space
    const float L = (logf(q) + logf(m - 1.0f) - logN - m * logf(m / beta) + b2h) / (1.0f - m);
    return m / beta - beta - expf(L);
  }
  return -ndtri_fast_wide(
      fminf(fmaxf((1.0f - q) * (C + D) / kSqrt2Pi, 1.1754943508222875e-38f), 1.0f));
}

// Discrete: the value before + loc.
__device__ __forceinline__ float ppf_bernoulli(float q, float p) {
  return q > 1.0f - p ? 1.0f : 0.0f;
}

__device__ __forceinline__ float ppf_geom(float q, float p) {
  return fmaxf(ceilf(log1pf(-q) / log1pf(-p)), 1.0f);
}

__device__ __forceinline__ float ppf_randint(float q, float low, float high) {
  const float k = ceilf(q * (high - low)) - 1.0f + low;
  return fminf(fmaxf(k, low), high - 1.0f);
}

}  // namespace ppf_ops
