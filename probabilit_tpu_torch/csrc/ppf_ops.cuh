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
// What bounds these branches on an H100 is instruction issue, not memory:
// a sample's draw and its family's few transcendentals.  So every body
// computes on fast_math.cuh's call-free functions (MUFU approximations and
// FMA polynomials) in straight-line code: no libm call, no IEEE division,
// and selects where the twin selects, both sides computed where both are
// cheap, so that a thread's four lanes interleave.  Where the twin's value
// turns on a float it rounded (an argument near a pole of tan, the log of
// a q near 1), the body computes the same float and then an accurate
// function of it: log_fast and log1p_fast keep relative accuracy near 1,
// tan_or_cot reduces near pi/2 by Cody-Waite; a log whose relative accuracy
// near 1 no value needs (it is added to a larger term, or it is the value
// itself, free in sign near 0) is log_mufu's lg2.approx, and log1p(q - 1)
// is log_fast(q) (q - 1 is exact on the draws).  A shape parameter
// divides as a multiplication by its reciprocal, hoisted out of the loop.
// ops/fast_math.py
// transcribes every body here in PyTorch for the CPU tests.  uniform, norm
// (ndtri_fast: __logf and sqrt.approx), triang (sqrt.approx), bernoulli
// and randint need none of it; geom keeps libm's log1pf (see there).  Draws are open-unit (q in [2^-24,
// 1 - 2^-24]), where every branch below is finite.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fast_math.cuh"
#include "sampling_math.cuh"

namespace ppf_ops {

using sampling_math::ndtri_fast;
namespace fm = fast_math;

constexpr float kPi = 3.141592653589793f;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kSqrt2Pi = 2.5066282746310002f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// ---- Closed forms -------------------------------------------------------

__device__ __forceinline__ float ppf_uniform(float q) { return q; }

__device__ __forceinline__ float ppf_norm(float q) { return ndtri_fast(q); }

__device__ __forceinline__ float ppf_expon(float q) { return -fm::log1p_fast(-q); }

__device__ __forceinline__ float ppf_lognorm(float q, float s) {
  return fm::exp_fast(s * ndtri_fast(q));
}

// The square roots are the hardware's (sampling_math::sqrt_approx).
__device__ __forceinline__ float ppf_triang(float q, float c) {
  const float left = sampling_math::sqrt_approx(q * c);
  const float right = 1.0f - sampling_math::sqrt_approx((1.0f - q) * (1.0f - c));
  return q <= c ? left : right;
}

// The survival form keeps windows in the upper tail: one wide quantile of
// the side the (loop-invariant) window selects.
__device__ __forceinline__ float ppf_truncnorm(float q, float a, float b) {
  const bool upper = a + b > 0.0f;
  const float lo = upper ? fm::ndtr_mufu(-a) : fm::ndtr_mufu(a);
  const float hi = upper ? fm::ndtr_mufu(-b) : fm::ndtr_mufu(b);
  const float z = fm::ndtri_wide_fast(lo + q * (hi - lo));
  return fminf(fmaxf(upper ? -z : z, a), b);
}

// The twin's float argument kPi * (q - 0.5f), then tan of that float.
__device__ __forceinline__ float ppf_cauchy(float q) { return fm::tan_fast(kPi * (q - 0.5f)); }

__device__ __forceinline__ float ppf_laplace(float q) {
  const bool low = q < 0.5f;
  const float v = fm::log_mufu(low ? 2.0f * q : 2.0f * (1.0f - q));
  return low ? v : -v;
}

__device__ __forceinline__ float ppf_logistic(float q) {
  return fm::log_mufu(q) - fm::log_mufu(1.0f - q);
}

__device__ __forceinline__ float ppf_gumbel_r(float q) {
  return -fm::log_mufu(-fm::log_fast(q));
}

__device__ __forceinline__ float ppf_gumbel_l(float q) {
  return fm::log_mufu(-fm::log1p_fast(-q));
}

__device__ __forceinline__ float ppf_rayleigh(float q) {
  return fm::sqrt_approx(-2.0f * fm::log1p_fast(-q));
}

__device__ __forceinline__ float ppf_halfnorm(float q) {
  return -fm::ndtri_wide_fast(0.5f * (1.0f - q));
}

__device__ __forceinline__ float ppf_pareto(float q, float b) {
  return fm::pow_fast(1.0f - q, fm::div_fast(-1.0f, b));
}

__device__ __forceinline__ float ppf_weibull_min(float q, float c) {
  return fm::pow_fast(-fm::log1p_fast(-q), fm::rcp_fast(c));
}

__device__ __forceinline__ float ppf_weibull_max(float q, float c) {
  return -fm::pow_fast(-fm::log_fast(q), fm::rcp_fast(c));
}

__device__ __forceinline__ float ppf_powerlaw(float q, float a) {
  return fm::pow_fast(q, fm::rcp_fast(a));
}

__device__ __forceinline__ float ppf_loguniform(float q, float a, float b) {
  const float la = fm::log_fast(a);
  return fm::exp_fast(la + q * (fm::log_fast(b) - la));
}

__device__ __forceinline__ float ppf_reciprocal(float q, float a, float b) {
  return ppf_loguniform(q, a, b);
}

__device__ __forceinline__ float ppf_arcsine(float q) {
  const float s = fm::sin_fast(kHalfPi * q);
  return s * s;
}

__device__ __forceinline__ float ppf_hypsecant(float q) {
  const float mag = fm::log_mufu(fm::tan_fast(kHalfPi * fminf(q, 1.0f - q)));
  return q < 0.5f ? mag : -mag;
}

__device__ __forceinline__ float ppf_fisk(float q, float c) {
  return fm::pow_fast(fm::div_fast(q, 1.0f - q), fm::rcp_fast(c));
}

// |c| < 1e-9 is a property of the node (a warp-uniform select).
__device__ __forceinline__ float ppf_genpareto(float q, float c) {
  const float l = fm::log1p_fast(-q);
  return fabsf(c) < 1e-9f ? -l : fm::expm1_fast(-c * l) * fm::rcp_fast(c);
}

__device__ __forceinline__ float ppf_genextreme(float q, float c) {
  const float ll = fm::log_mufu(-fm::log_fast(q));
  return fabsf(c) < 1e-9f ? -ll : -(fm::expm1_fast(c * ll) * fm::rcp_fast(c));
}

// CDF = ndtr(a - 1/x) / ndtr(a); past q = 0.999 the first-order tail form.
__device__ __forceinline__ float ppf_alpha(float q, float a) {
  const float na = fm::ndtr_mufu(a);
  const float D = na * (1.0f - q) * fm::rcp_fast(kInvSqrt2Pi * fm::exp_fast(-0.5f * a * a));
  const float tail = fm::rcp_fast(D * (1.0f - 0.5f * a * D));
  const float body = fm::rcp_fast(a - fm::ndtri_wide_fast(q * na));
  return q > 0.999f ? tail : body;
}

__device__ __forceinline__ float ppf_bradford(float q, float c) {
  return fm::expm1_fast(q * fm::log1p_fast(c)) * fm::rcp_fast(c);
}

__device__ __forceinline__ float ppf_burr(float q, float c, float d) {
  const float t = fm::expm1_fast(-fm::log_fast(q) * fm::rcp_fast(d));  // log1p(q - 1)
  return fm::pow_fast(t, fm::div_fast(-1.0f, c));
}

__device__ __forceinline__ float ppf_burr12(float q, float c, float d) {
  const float t = fm::expm1_fast(-fm::log1p_fast(-q) * fm::rcp_fast(d));
  return fm::pow_fast(t, fm::rcp_fast(c));
}

__device__ __forceinline__ float ppf_dweibull(float q, float c) {
  const bool low = q < 0.5f;
  const float t = fmaxf(low ? 2.0f * q : 2.0f * (1.0f - q), 1e-12f);
  const float mag = fm::pow_fast(-fm::log_fast(t), fm::rcp_fast(c));
  return low ? -mag : mag;
}

__device__ __forceinline__ float ppf_exponpow(float q, float b) {
  return fm::pow_fast(fm::log1p_fast(-fm::log1p_fast(-q)), fm::rcp_fast(b));
}

__device__ __forceinline__ float ppf_exponweib(float q, float a, float c) {
  const float t = -fm::expm1_fast(fm::log_fast(q) * fm::rcp_fast(a));  // log1p(q - 1)
  return fm::pow_fast(-fm::log_fast(t), fm::rcp_fast(c));
}

__device__ __forceinline__ float ppf_fatiguelife(float q, float c) {
  const float t = c * ndtri_fast(q);
  const float r = t + fm::sqrt_approx(t * t + 4.0f);
  return 0.25f * (r * r);
}

__device__ __forceinline__ float ppf_genhalflogistic(float q, float c) {
  const float t = fm::div_fast(1.0f - q, 1.0f + q);
  return (1.0f - fm::pow_fast(t, c)) * fm::rcp_fast(c);
}

__device__ __forceinline__ float ppf_genlogistic(float q, float c) {
  return -fm::log_mufu(fm::expm1_fast(-fm::log_fast(q) * fm::rcp_fast(c)));  // log1p(q - 1)
}

__device__ __forceinline__ float ppf_gibrat(float q) { return fm::exp_fast(ndtri_fast(q)); }

__device__ __forceinline__ float ppf_gompertz(float q, float c) {
  return fm::log1p_fast(-fm::log1p_fast(-q) * fm::rcp_fast(c));
}

// The cotangent of the twin's complementary angle: 1 / tan x as cot x.
__device__ __forceinline__ float ppf_halfcauchy(float q) {
  return fm::cot_fast(kHalfPi * (1.0f - q));
}

// log1p(q) - log1p(-q) = 2 atanh q = log1p(2q / (1 - q)): one log.
__device__ __forceinline__ float ppf_halflogistic(float q) {
  return fm::log1p_fast(fm::div_fast(2.0f * q, 1.0f - q));
}

__device__ __forceinline__ float ppf_invweibull(float q, float c) {
  return fm::pow_fast(-fm::log_fast(q), fm::div_fast(-1.0f, c));  // log1p(q - 1)
}

__device__ __forceinline__ float ppf_johnsonsb(float q, float a, float b) {
  const float z = (ndtri_fast(q) - a) * fm::rcp_fast(b);
  return fm::rcp_fast(1.0f + fm::exp_fast(-z));
}

__device__ __forceinline__ float ppf_johnsonsu(float q, float a, float b) {
  const float ez = fm::exp_fast((ndtri_fast(q) - a) * fm::rcp_fast(b));
  return 0.5f * (ez - fm::rcp_fast(ez));
}

__device__ __forceinline__ float ppf_kappa3(float q, float a) {
  const float z = a * fm::log_fast(q);  // log1p(q - 1)
  const float ratio = fm::div_fast(fm::exp_fast(z), -fm::expm1_fast(z));
  return fm::pow_fast(a * ratio, fm::rcp_fast(a));
}

__device__ __forceinline__ float ppf_laplace_asymmetric(float q, float kappa) {
  const float k2 = kappa * kappa;
  const bool low = q < fm::div_fast(k2, 1.0f + k2);
  const float t = low ? q * (1.0f + k2) * fm::rcp_fast(k2) : (1.0f - q) * (1.0f + k2);
  const float v = fm::log_mufu(fmaxf(t, 1e-30f));
  return low ? kappa * v : -v * fm::rcp_fast(kappa);
}

__device__ __forceinline__ float ppf_levy(float q) {
  const float z = fm::ndtri_wide_fast(0.5f * q);
  return fm::rcp_fast(z * z);
}

__device__ __forceinline__ float ppf_levy_l(float q) {
  const float z = fm::ndtri_wide_fast(0.5f * (1.0f - q));
  return -fm::rcp_fast(z * z);
}

__device__ __forceinline__ float ppf_loglaplace(float q, float c) {
  const bool low = q < 0.5f;
  const float t = fmaxf(low ? 2.0f * q : 2.0f * (1.0f - q), 1e-30f);
  return fm::pow_fast(t, low ? fm::rcp_fast(c) : fm::div_fast(-1.0f, c));
}

__device__ __forceinline__ float ppf_lomax(float q, float c) {
  return fm::expm1_fast(-fm::log1p_fast(-q) * fm::rcp_fast(c));
}

__device__ __forceinline__ float ppf_mielke(float q, float k, float s) {
  const float z = fm::div_fast(s, k) * fm::log_fast(q);  // log1p(q - 1)
  const float ratio = fm::div_fast(fm::exp_fast(z), -fm::expm1_fast(z));
  return fm::pow_fast(ratio, fm::rcp_fast(s));
}

__device__ __forceinline__ float ppf_moyal(float q) {
  return -2.0f * fm::log_mufu(-fm::ndtri_wide_fast(0.5f * q));
}

// ndtri((1 - q)^(1/c)), through -ndtri(1 - w) for q < 1/2: one wide
// quantile of the argument the lane selects.
__device__ __forceinline__ float powernorm_score(float q, float c) {
  const bool low = q < 0.5f;
  const float one_minus_w = -fm::expm1_fast(fm::log1p_fast(-q) * fm::rcp_fast(c));
  const float w = fm::pow_fast(1.0f - q, fm::rcp_fast(c));
  const float z = fm::ndtri_wide_fast(low ? fmaxf(one_minus_w, 1.1754943508222875e-38f) : w);
  return low ? -z : z;
}

__device__ __forceinline__ float ppf_powerlognorm(float q, float c, float s) {
  return fm::exp_fast(-s * powernorm_score(q, c));
}

__device__ __forceinline__ float ppf_powernorm(float q, float c) {
  return -powernorm_score(q, c);
}

__device__ __forceinline__ float ppf_trapezoid(float q, float c, float d) {
  const float h = fm::div_fast(2.0f, 1.0f + d - c);
  const float rh = fm::rcp_fast(h);
  const float rise = fm::sqrt_approx(fmaxf(2.0f * c * q * rh, 0.0f));
  const float flat = q * rh + 0.5f * c;
  const float fall = 1.0f - fm::sqrt_approx(fmaxf(2.0f * (1.0f - d) * (1.0f - q) * rh, 0.0f));
  return q < 0.5f * h * c ? rise : (q < h * (d - 0.5f * c) ? flat : fall);
}

__device__ __forceinline__ float ppf_truncexpon(float q, float b) {
  return -fm::log1p_fast(q * fm::expm1_fast(-b));
}

__device__ __forceinline__ float ppf_truncpareto(float q, float b, float c) {
  return fm::pow_fast(1.0f - q * (1.0f - fm::pow_fast(c, -b)), fm::div_fast(-1.0f, b));
}

__device__ __forceinline__ float ppf_truncweibull_min(float q, float c, float a, float b) {
  const float sa = fm::exp_fast(-fm::pow_fast(a, c));
  const float sb = fm::exp_fast(-fm::pow_fast(b, c));
  return fm::pow_fast(-fm::log_fast(sa - q * (sa - sb)), fm::rcp_fast(c));
}

// |lam| < 1e-7 is a property of the node (a warp-uniform select).
__device__ __forceinline__ float ppf_tukeylambda(float q, float lam) {
  if (fabsf(lam) < 1e-7f) return fm::log_mufu(q) - fm::log_mufu(1.0f - q);
  return (fm::pow_fast(q, lam) - fm::pow_fast(1.0f - q, lam)) * fm::rcp_fast(lam);
}

// Two Cauchy half-bodies of widths w = 1 -+ a glued at f0 = (1 - a) / 2;
// past each half-body's midpoint the cotangent of the complementary
// argument.  One tan_or_cot a lane: the side and the form are selects.
__device__ __forceinline__ float ppf_skewcauchy(float q, float a) {
  const float wl = 1.0f - a, wu = 1.0f + a;
  const float f0 = 0.5f * wl;
  const bool lower = q < f0;
  const bool tail = lower ? q < 0.5f * f0 : q > f0 + 0.5f * wu * 0.5f;
  const float w = lower ? wl : wu;
  const float arg = tail ? (lower ? q : 1.0f - q) : q - f0;
  const float t = fm::tan_or_cot(kPi * arg * (lower ? fm::rcp_fast(wl) : fm::rcp_fast(wu)), tail);
  return w * (tail && lower ? -t : t);
}

// scipy's switch on exact zeros of h and k is a property of the node.
__device__ __forceinline__ float ppf_kappa4(float q, float h, float k) {
  const float logq = fm::log_fast(q);
  const float t = h == 0.0f ? -logq : -(fm::expm1_fast(h * logq) * fm::rcp_fast(h));
  const float logt = fm::log_mufu(t);
  return k == 0.0f ? -logt : -(fm::expm1_fast(k * logt) * fm::rcp_fast(k));
}

// The power-law tail inverted in log space below q = N C, the Gaussian core
// above it; both computed, one selected.
__device__ __forceinline__ float ppf_crystalball(float q, float beta, float m) {
  const float b2h = 0.5f * beta * beta;
  const float C = fm::div_fast(m, beta * (m - 1.0f)) * fm::exp_fast(-b2h);
  const float D = kSqrt2Pi * fm::ndtr_mufu(beta);
  const float logN = -fm::log_fast(C + D);
  const float L = (fm::log_mufu(q) + fm::log_fast(m - 1.0f) - logN -
                   m * fm::log_fast(fm::div_fast(m, beta)) + b2h) *
                  fm::rcp_fast(1.0f - m);
  const float x_pow = fm::div_fast(m, beta) - beta - fm::exp_fast(L);
  // A lane of the power tail gives the core 1/2: its clamped argument, 1,
  // would take the quantile's far-tail branch for nothing.
  const bool tail = q < fm::exp_fast(logN) * C;
  const float core = fminf(fmaxf((1.0f - q) * (C + D) * kInvSqrt2Pi, 1.1754943508222875e-38f), 1.0f);
  const float x_gauss = -fm::ndtri_wide_fast(tail ? 0.5f : core);
  return tail ? x_pow : x_gauss;
}

// Discrete: the value before + loc.
__device__ __forceinline__ float ppf_bernoulli(float q, float p) {
  return q > 1.0f - p ? 1.0f : 0.0f;
}

// The ceiling of a ratio of logs.  Where the ratio is an integer (q = 1 -
// (1 - p)^k on the draws' grid) an ulp of either log is a whole step of the
// value, and the twin's step there is the one CUDA's log1pf rounds to: on
// an H100, log1pf(-0.25) and log1pf(-0.4375) are an ulp off the correctly
// rounded floats, and the twin's geom(0.25) is k + 1 at 8 of the 11 such q
// (PERF.md).  So geom alone keeps libm's log1pf (inline: no call,
// no MUFU), and divides as IEEE does, through fast_math::div_rounded.
__device__ __forceinline__ float ppf_geom(float q, float p) {
  return fmaxf(ceilf(fm::div_rounded(log1pf(-q), log1pf(-p))), 1.0f);
}

__device__ __forceinline__ float ppf_randint(float q, float low, float high) {
  const float k = ceilf(q * (high - low)) - 1.0f + low;
  return fminf(fmaxf(k, low), high - 1.0f);
}

}  // namespace ppf_ops
