// newton_ops.cuh: the Newton tier of the graph megakernel.
//
// Replaces what probabilit_tpu/engine/pallas_exec.py's kernel body lowers
// for the families of _INCOMPLETE_FAMILY_CAPS (pallas_exec.py:118-156):
// probabilit_tpu/ops/special.py's gammaincinv (:609) and betaincinv
// (:705) under _kernel_safe_special, inside each ppf.  Each family's
// quantile is ppf_<family>_value(q, x, shapes) of the inverse x of the
// incomplete gamma P(a, x) or beta I_x(a, b) function at the (a, b, p)
// that ppf_<family>_args(q, shapes) gives; both transcribe the family's
// plain twin in ops/ppf.py at the default loc (and scale).
//
// What bounds it on an H100: float32 operations, a safeguarded Newton
// loop of 4-7 trips a quantile on average, each around a continued
// fraction or a series that converges in 1-4 pairs on most lanes and in
// up to 40 on a few.  A loop per lane, four lanes a thread one after the
// other, runs every warp as long as its slowest lane, four times over,
// and a fixed-length fraction pays 40 pairs on every trip.  What the
// design does about it:
//
//  * The generated kernel writes the quantiles of a block's turn to
//    shared memory (one float per sample and Newton row; a turn of a graph
//    with few Newton rows covers several groups a thread, so that a block
//    solves about 12 K quantiles at once), and the whole block solves them
//    together (solve): a lane that finishes a quantile takes the next one
//    from a block-wide counter (one atomicAdd a warp), so a warp runs as
//    long as its share of the work, not as long as its slowest quantile.
//    The value replaces the quantile in place, and the straight-line code
//    reads it back: the rest of the graph keeps its registers, and its
//    code is not repeated for four lanes.
//  * A lane advances one term of its series or one pair of its fraction
//    per turn and stops where it has converged (series: term <= total *
//    2^-24; fractions: |d c - 1| <= 2^-24), capped at the twin's 48 terms
//    and 40 pairs.  A lane whose fraction has converged waits until
//    kBatch lanes of its warp (or every live one) have, and then they end
//    their Newton trips together: a warp runs the trip's logs and
//    exponentials once per batch, not once per lane.
//  * A kernel holds the code of its own families alone: kFamilies, the
//    bits of the tape's Newton families, is a template argument, so a t
//    node's kernel carries no gamma series and no argus normaliser (with
//    all 15 families switched at run time its solve loop was about 5,000
//    SASS instructions, and the t family ran 40% longer).
//  * Direct and flipped beta fractions are one code path on swapped
//    operands (a, b, x) or (b, a, 1 - x), so a warp never runs both, and
//    the generator numbers the gamma rows first, so the two kinds meet in
//    a warp only where they change.
//
// A lane's arithmetic depends only on its quantile and its row's
// parameters, never on which lane of which warp takes it or when: the
// values stay the same for any start, n, block or grid.  Only rounding
// separates the stopped fractions from the twin's fixed counts
// (ops/special.py under kernel_safe_special); the Newton trips, their
// caps (26 gamma, 40 beta), steps, brackets and freeze test (a lane keeps
// the value it had before the trip whose step and residual are both
// within tolerance) are the twin's.  engine/newton_tier.py transcribes
// this loop for the tests and counts its trips, pairs and terms.
//
// Division and libm calls are IEEE (no fast-math flags); the compiler may
// contract a multiply and an add into an FMA where the twin rounds twice.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "special_ops.cuh"

namespace newton_ops {

using special_ops::kTiny;
using special_ops::lentz_guard;
using special_ops::lgamma_kernel;
using special_ops::ndtri_fast_wide;

constexpr float kStop = 5.9604644775390625e-8f;  // 2^-24
constexpr int kGammaTrips = 26;
constexpr int kBetaTrips = 40;
constexpr int kGammaTerms = 48;
constexpr int kBetaPairs = 40;
constexpr int kBatch = 28;  // lanes of a warp that end their Newton trips together

enum Kind : int { kGamma = 0, kBeta = 1 };

// The inverse a family asks for: P(a, x) = p or I_x(a, b) = p.
struct Args {
  int kind;
  float a, b, p;
};

__device__ __forceinline__ Args gamma_args(float a, float p) { return Args{kGamma, a, 0.0f, p}; }

__device__ __forceinline__ Args beta_args(float a, float b, float p) {
  return Args{kBeta, a, b, p};
}

// A row's constants, once per block: gamma (lgamma(a), lgamma(a + 1));
// beta (log B(a, b), -log B(a, b)) in the twin's orders.
__device__ __forceinline__ float2 row_constants(Args r) {
  if (r.kind == kGamma) return make_float2(lgamma_kernel(r.a), lgamma_kernel(r.a + 1.0f));
  const float lg_a = lgamma_kernel(r.a), lg_b = lgamma_kernel(r.b);
  const float lg_ab = lgamma_kernel(r.a + r.b);
  return make_float2(lg_a + lg_b - lg_ab, lg_ab - lg_a - lg_b);
}

// ---- The 15 families: their inverse's arguments and their value ---------

__device__ __forceinline__ Args ppf_gamma_args(float q, float a) { return gamma_args(a, q); }
__device__ __forceinline__ float ppf_gamma_value(float, float x, float) { return x; }

__device__ __forceinline__ Args ppf_invgamma_args(float q, float a) {
  return gamma_args(a, 1.0f - q);
}
__device__ __forceinline__ float ppf_invgamma_value(float, float x, float) { return 1.0f / x; }

__device__ __forceinline__ Args ppf_chi2_args(float q, float df) {
  return gamma_args(0.5f * df, q);
}
__device__ __forceinline__ float ppf_chi2_value(float, float x, float) { return 2.0f * x; }

__device__ __forceinline__ Args ppf_chi_args(float q, float df) {
  return gamma_args(0.5f * df, q);
}
__device__ __forceinline__ float ppf_chi_value(float, float x, float) { return sqrtf(2.0f * x); }

__device__ __forceinline__ Args ppf_maxwell_args(float q) { return gamma_args(1.5f, q); }
__device__ __forceinline__ float ppf_maxwell_value(float, float x) { return sqrtf(2.0f * x); }

__device__ __forceinline__ Args ppf_nakagami_args(float q, float nu) { return gamma_args(nu, q); }
__device__ __forceinline__ float ppf_nakagami_value(float, float x, float nu) {
  return sqrtf(x / nu);
}

__device__ __forceinline__ Args ppf_beta_args(float q, float a, float b) {
  return beta_args(a, b, q);
}
__device__ __forceinline__ float ppf_beta_value(float, float x, float, float) { return x; }

__device__ __forceinline__ Args ppf_betaprime_args(float q, float a, float b) {
  return beta_args(a, b, q);
}
__device__ __forceinline__ float ppf_betaprime_value(float, float x, float, float) {
  return x / (1.0f - x);
}

// Two-tailed: I_x(df/2, 1/2) = 2 min(q, 1 - q).
__device__ __forceinline__ Args ppf_t_args(float q, float df) {
  return beta_args(0.5f * df, 0.5f, 2.0f * fminf(q, 1.0f - q));
}
__device__ __forceinline__ float ppf_t_value(float q, float x, float df) {
  const float tval = sqrtf(df * (1.0f - x) / fmaxf(x, 1e-30f));
  return q < 0.5f ? -tval : tval;
}

__device__ __forceinline__ Args ppf_f_args(float q, float dfn, float dfd) {
  return beta_args(0.5f * dfn, 0.5f * dfd, q);
}
__device__ __forceinline__ float ppf_f_value(float, float x, float dfn, float dfd) {
  return (dfd * x) / (dfn * (1.0f - x));
}

__device__ __forceinline__ Args ppf_dgamma_args(float q, float a) {
  return gamma_args(a, q < 0.5f ? 1.0f - fminf(fmaxf(2.0f * q, 1e-7f), 1.0f)
                                : fminf(fmaxf(2.0f * q - 1.0f, 0.0f), 0.9999999f));
}
__device__ __forceinline__ float ppf_dgamma_value(float q, float x, float) {
  return q < 0.5f ? -x : x;
}

__device__ __forceinline__ Args ppf_loggamma_args(float q, float c) { return gamma_args(c, q); }
__device__ __forceinline__ float ppf_loggamma_value(float, float x, float) { return logf(x); }

__device__ __forceinline__ Args ppf_gengamma_args(float q, float a, float c) {
  return gamma_args(a, c > 0.0f ? q : 1.0f - q);
}
__device__ __forceinline__ float ppf_gengamma_value(float, float x, float, float c) {
  return powf(x, 1.0f / c);
}

__device__ __forceinline__ Args ppf_rdist_args(float q, float c) {
  return beta_args(0.5f * c, 0.5f * c, q);
}
__device__ __forceinline__ float ppf_rdist_value(float, float x, float) { return 2.0f * x - 1.0f; }

// SF = P(3/2, chi^2 (1 - x^2)/2) / P(3/2, chi^2/2); near x = 0 two
// Newton steps on the cubic series of the CDF in y = x^2.
__device__ __forceinline__ float argus_p_chi(float chi) {
  return special_ops::gammainc_kernel(1.5f, 0.5f * chi * chi, lgamma_kernel(1.5f));
}
__device__ __forceinline__ Args ppf_argus_args(float q, float chi) {
  return gamma_args(1.5f, (1.0f - q) * argus_p_chi(chi));
}
__device__ __forceinline__ float ppf_argus_value(float q, float u, float chi) {
  const float a = 0.5f * chi * chi;
  const float p_chi = argus_p_chi(chi);
  const float x = sqrtf(fmaxf(1.0f - u / a, 0.0f));
  if (!(x * x < 0.05f / fmaxf(a, 1.0f))) return x;
  const float k = chi * chi * chi * expf(-a) / (2.5066282746310002f * 0.5f * p_chi);
  const float c2 = 0.25f * (a - 0.5f);
  const float c3 = (0.5f * a * a - 0.5f * a - 0.125f) / 6.0f;
  const float target = q / k;
  float y = 2.0f * target;
  for (int i = 0; i < 2; ++i) {
    const float g = y * (0.5f + y * (c2 + y * c3));
    const float gp = 0.5f + y * (2.0f * c2 + y * 3.0f * c3);
    y = fmaxf(y - (g - target) / gp, 0.0f);
  }
  return sqrtf(fmaxf(y, 0.0f));
}

// ---- A row of the tape: its family, shapes and constants ----------------

// The generated kernel names a Newton row's family by these ids
// (engine/cuda_exec.py's _NEWTON_FAMILY_ID).
enum Family : int {
  kFamGamma, kFamInvgamma, kFamChi2, kFamChi, kFamMaxwell, kFamNakagami, kFamBeta,
  kFamBetaprime, kFamT, kFamF, kFamDgamma, kFamLoggamma, kFamGengamma, kFamRdist, kFamArgus,
};

// A Newton row in shared memory: its family, its shape parameters (0 where
// the family has fewer) and its row_constants.
struct Row {
  int family;
  float s0, s1;
  float lg0, lg1;
};

// The families of each kind, as bits of a kernel's kFamilies.
constexpr unsigned kGammaFamilies =
    (1u << kFamGamma) | (1u << kFamInvgamma) | (1u << kFamChi2) | (1u << kFamChi) |
    (1u << kFamMaxwell) | (1u << kFamNakagami) | (1u << kFamDgamma) | (1u << kFamLoggamma) |
    (1u << kFamGengamma) | (1u << kFamArgus);
constexpr unsigned kBetaFamilies =
    (1u << kFamBeta) | (1u << kFamBetaprime) | (1u << kFamT) | (1u << kFamF) | (1u << kFamRdist);

// Is `family` the family `id`?  kFamilies, the bits of the families a
// generated kernel holds, is known when it is compiled: a family it does
// not hold is false at compile time, so its code is never emitted, and a
// kernel of one family needs no test.
template <unsigned kFamilies>
__device__ __forceinline__ bool is_family(int family, Family id) {
  return (kFamilies & (1u << id)) != 0u && (kFamilies == (1u << id) || family == id);
}

template <unsigned kFamilies>
__device__ __forceinline__ Args family_args(int family, float q, float s0, float s1) {
  if (is_family<kFamilies>(family, kFamGamma)) return ppf_gamma_args(q, s0);
  if (is_family<kFamilies>(family, kFamInvgamma)) return ppf_invgamma_args(q, s0);
  if (is_family<kFamilies>(family, kFamChi2)) return ppf_chi2_args(q, s0);
  if (is_family<kFamilies>(family, kFamChi)) return ppf_chi_args(q, s0);
  if (is_family<kFamilies>(family, kFamMaxwell)) return ppf_maxwell_args(q);
  if (is_family<kFamilies>(family, kFamNakagami)) return ppf_nakagami_args(q, s0);
  if (is_family<kFamilies>(family, kFamBeta)) return ppf_beta_args(q, s0, s1);
  if (is_family<kFamilies>(family, kFamBetaprime)) return ppf_betaprime_args(q, s0, s1);
  if (is_family<kFamilies>(family, kFamT)) return ppf_t_args(q, s0);
  if (is_family<kFamilies>(family, kFamF)) return ppf_f_args(q, s0, s1);
  if (is_family<kFamilies>(family, kFamDgamma)) return ppf_dgamma_args(q, s0);
  if (is_family<kFamilies>(family, kFamLoggamma)) return ppf_loggamma_args(q, s0);
  if (is_family<kFamilies>(family, kFamGengamma)) return ppf_gengamma_args(q, s0, s1);
  if (is_family<kFamilies>(family, kFamRdist)) return ppf_rdist_args(q, s0);
  return ppf_argus_args(q, s0);
}

template <unsigned kFamilies>
__device__ __forceinline__ float family_value(int family, float q, float x, float s0, float s1) {
  if (is_family<kFamilies>(family, kFamGamma)) return ppf_gamma_value(q, x, s0);
  if (is_family<kFamilies>(family, kFamInvgamma)) return ppf_invgamma_value(q, x, s0);
  if (is_family<kFamilies>(family, kFamChi2)) return ppf_chi2_value(q, x, s0);
  if (is_family<kFamilies>(family, kFamChi)) return ppf_chi_value(q, x, s0);
  if (is_family<kFamilies>(family, kFamMaxwell)) return ppf_maxwell_value(q, x);
  if (is_family<kFamilies>(family, kFamNakagami)) return ppf_nakagami_value(q, x, s0);
  if (is_family<kFamilies>(family, kFamBeta)) return ppf_beta_value(q, x, s0, s1);
  if (is_family<kFamilies>(family, kFamBetaprime)) return ppf_betaprime_value(q, x, s0, s1);
  if (is_family<kFamilies>(family, kFamT)) return ppf_t_value(q, x, s0);
  if (is_family<kFamilies>(family, kFamF)) return ppf_f_value(q, x, s0, s1);
  if (is_family<kFamilies>(family, kFamDgamma)) return ppf_dgamma_value(q, x, s0);
  if (is_family<kFamilies>(family, kFamLoggamma)) return ppf_loggamma_value(q, x, s0);
  if (is_family<kFamilies>(family, kFamGengamma)) return ppf_gengamma_value(q, x, s0, s1);
  if (is_family<kFamilies>(family, kFamRdist)) return ppf_rdist_value(q, x, s0);
  return ppf_argus_value(q, x, s0);
}

// A row from its family and shapes: its inverse's constants depend on the
// shapes alone (the quantile 0.5 stands in for any).
template <unsigned kFamilies>
__device__ __forceinline__ Row make_row(int family, float s0, float s1) {
  const float2 lg = row_constants(family_args<kFamilies>(family, 0.5f, s0, s1));
  return Row{family, s0, s1, lg.x, lg.y};
}

// ---- One lane's solve, as a state machine -------------------------------

// A lane's quantile in flight: its Newton state (gamma: log x; beta: x and
// its bracket) and its fraction or series.
struct Lane {
  int item;   // index of the quantile in the block's work, or -1
  int row;    // its Newton row
  int slot;   // where the quantile lies in shared memory
  int kind;
  int trips;  // Newton trips ended
  int mode;   // 0: gamma series, 1: gamma fraction, 2: beta fraction
  int k;      // terms or pairs taken in this trip
  bool in_frac;
  bool direct;  // beta: the fraction on (a, b, x), not (b, a, 1 - x)
  float q, a, b, p, p_c, lg0, lg1;
  float x, lo, hi;  // gamma: x is log x
  float fa, fb, fx;  // the fraction's operands (gamma: fb is x itself)
  float c, d, h;     // Lentz's c, d and h (the series: d its term, h its sum)
  float pre;         // gamma: log of the prefactor; beta: the prefactor
};

// Does the lane solve P(a, x) = p?  Known at compile time in a kernel
// whose families are all of one kind, so the other kind's code is never
// emitted.
template <unsigned kFamilies>
__device__ __forceinline__ bool is_gamma(const Lane& L) {
  if ((kFamilies & kBetaFamilies) == 0u) return true;
  if ((kFamilies & kGammaFamilies) == 0u) return false;
  return L.kind == kGamma;
}

// The guess of gammaincinv (Wilson-Hilferty; the power law x^a / Gamma(a
// + 1) for a < 0.5) or of betaincinv (A & S 26.5.22; the power-law tail
// inverse for a <= 1 or b <= 1).
template <unsigned kFamilies>
__device__ __forceinline__ void start_item(Lane& L) {
  if (is_gamma<kFamilies>(L)) {
    const float a = L.a;
    L.p_c = fminf(fmaxf(L.p, kTiny), 0.9999999f);
    const float s = 1.0f / (9.0f * a);
    const float z = ndtri_fast_wide(L.p_c);
    const float base = 1.0f - s + z * sqrtf(s);
    float guess = a * (base * base * base);
    if (a < 0.5f || guess <= 0.0f) guess = expf((logf(fmaxf(L.p_c, kTiny)) + L.lg1) / a);
    L.x = logf(fmaxf(guess, kTiny));
  } else {
    const float a = L.a, b = L.b;
    L.p_c = fminf(fmaxf(L.p, 1e-7f), 0.9999999f);
    const float y = ndtri_fast_wide(L.p_c);
    const float la = 1.0f / (2.0f * a - 1.0f);
    const float lb = 1.0f / (2.0f * b - 1.0f);
    const float h = 2.0f / (la + lb);
    const float w = y * sqrtf(h + (y * y - 3.0f) / 6.0f) / h -
                    (lb - la) * ((y * y - 3.0f) / 6.0f + 0.8333333333333334f - 2.0f / (3.0f * h));
    float guess = a / (a + b * expf(2.0f * w));
    if (a <= 1.0f || b <= 1.0f || !isfinite(guess)) {
      guess = expf((logf(fmaxf(L.p_c, kTiny)) + L.lg0 + logf(a)) / a);
    }
    L.x = fminf(fmaxf(guess, 1e-6f), 0.999999f);
    L.lo = 0.0f;
    L.hi = 1.0f;
  }
  L.trips = 0;
}

// A trip's incomplete function, set up: gamma's series for x < a + 1,
// else its continued fraction for Q; beta's fraction on the operands the
// lane selects.
template <unsigned kFamilies>
__device__ __forceinline__ void begin_trip(Lane& L) {
  L.k = 0;
  L.in_frac = true;
  if (is_gamma<kFamilies>(L)) {
    const float a = L.a;
    const float xv = expf(L.x);
    const float xs = fmaxf(xv, kTiny);
    L.fb = xv;
    L.fx = xs;
    L.pre = a * logf(xs) - xs - L.lg0;
    if (xs < a + 1.0f) {
      L.mode = 0;
      L.d = 1.0f / a;
      L.h = L.d;
    } else {
      L.mode = 1;
      L.c = 1e30f;
      L.d = 1.0f / lentz_guard(xs + 1.0f - a);
      L.h = L.d;
    }
    return;
  }
  const float a = L.a, b = L.b;
  const float xc = fminf(fmaxf(L.x, kTiny), 0.9999999f);
  L.pre = expf(L.lg1 + a * logf(xc) + b * log1pf(-xc));
  L.direct = xc < (a + 1.0f) / (a + b + 2.0f);
  L.fa = L.direct ? a : b;
  L.fb = L.direct ? b : a;
  L.fx = L.direct ? xc : 1.0f - xc;
  L.mode = 2;
  L.c = 1.0f;
  L.d = 1.0f / lentz_guard(1.0f - (L.fa + L.fb) * L.fx / (L.fa + 1.0f));
  L.h = L.d;
}

// One term of the series, or one step (gamma) or even/odd pair (beta) of
// Lentz's fraction; the lane leaves the fraction where it has converged
// or at its cap.
template <unsigned kFamilies>
__device__ __forceinline__ void fraction_step(Lane& L) {
  const float kf = static_cast<float>(L.k);
  bool done;
  if (is_gamma<kFamilies>(L) && L.mode == 0) {
    L.d = L.d * L.fx / (L.a + 1.0f + kf);
    L.h = L.h + L.d;
    done = L.d <= L.h * kStop || L.k + 1 == kGammaTerms;
  } else if (is_gamma<kFamilies>(L)) {
    const float i1 = kf + 1.0f;
    const float an = -i1 * (i1 - L.a);
    const float bb = L.fx + 1.0f - L.a + 2.0f * i1;
    L.d = 1.0f / lentz_guard(bb + an * L.d);
    L.c = lentz_guard(bb + an / L.c);
    L.h = L.h * L.d * L.c;
    done = fabsf(L.d * L.c - 1.0f) <= kStop || L.k + 1 == kGammaTerms;
  } else {
    const float pa = L.fa, pb = L.fb, x = L.fx;
    const float m = kf + 1.0f;
    const float two_m = 2.0f * m;
    float aa = m * (pb - m) * x / ((pa - 1.0f + two_m) * (pa + two_m));
    L.d = 1.0f / lentz_guard(1.0f + aa * L.d);
    L.c = lentz_guard(1.0f + aa / L.c);
    L.h = L.h * L.d * L.c;
    aa = -(pa + m) * (pa + pb + m) * x / ((pa + two_m) * (pa + 1.0f + two_m));
    L.d = 1.0f / lentz_guard(1.0f + aa * L.d);
    L.c = lentz_guard(1.0f + aa / L.c);
    L.h = L.h * L.d * L.c;
    done = fabsf(L.d * L.c - 1.0f) <= kStop || L.k + 1 == kBetaPairs;
  }
  L.k += 1;
  L.in_frac = !done;
}

// The end of a Newton trip: the residual f, the step, the freeze test.
// Returns true where the lane is done (frozen, or at its trip cap).
template <unsigned kFamilies>
__device__ __forceinline__ bool end_trip(Lane& L) {
  if (is_gamma<kFamilies>(L)) {
    const float a = L.a;
    float p = L.mode == 0 ? L.h * expf(L.pre) : 1.0f - expf(L.pre) * L.h;
    if (L.fb <= 0.0f) p = 0.0f;
    p = fminf(fmaxf(p, 0.0f), 1.0f);
    const float f = p - L.p_c;
    float step = f * expf(-(a * L.x - L.fb - L.lg0));
    step = fminf(fmaxf(step, -2.0f), 2.0f);
    if (fabsf(step) <= 3e-5f && fabsf(f) <= 1e-4f) return true;
    L.x = L.x - step;
    return ++L.trips == kGammaTrips;
  }
  const float a = L.a, b = L.b, x = L.x;
  float p = L.direct ? L.pre * L.h / a : 1.0f - L.pre * L.h / b;
  if (x <= 0.0f) p = 0.0f;
  if (x >= 1.0f) p = 1.0f;
  p = fminf(fmaxf(p, 0.0f), 1.0f);
  const float f = p - L.p_c;
  if (f < 0.0f) L.lo = x;
  if (f > 0.0f) L.hi = x;
  const float log_pdf = (a - 1.0f) * logf(x) + (b - 1.0f) * log1pf(-x) - L.lg0;
  const float newton = x - f * expf(-log_pdf);
  const bool bad = !isfinite(newton) || newton <= L.lo || newton >= L.hi;
  const float x_new = bad ? 0.5f * (L.lo + L.hi) : newton;
  if (fabsf(x_new - x) / fmaxf(x, kTiny) <= 3e-5f && fabsf(f) <= 1e-4f) return true;
  L.x = x_new;
  return ++L.trips == kBetaTrips;
}

// The inverse at the lane's end, with the twin's values at p <= 0 and p >= 1.
template <unsigned kFamilies>
__device__ __forceinline__ float inverse(const Lane& L) {
  if (is_gamma<kFamilies>(L)) {
    float x = expf(L.x);
    if (L.p <= 0.0f) x = 0.0f;
    if (L.p >= 1.0f) x = INFINITY;
    return x;
  }
  float x = L.x;
  if (L.p <= 0.0f) x = 0.0f;
  if (L.p >= 1.0f) x = 1.0f;
  return x;
}

// Solve the block's quantiles of rows 0 .. n_rows - 1, which lie in
// `slots`: row j's of group s * kThreads + t of the turn (thread t's s-th
// group) and lane l at ((j * kGroups + s) * 4 + l) * kThreads + t, for
// the turn's first live_groups groups.  Every thread of the block calls
// it, after a __syncthreads() that follows the writes of the quantiles
// and of *next = 0; each value replaces its quantile.
template <int kThreads, int kGroups, unsigned kFamilies>
__device__ __forceinline__ void solve(float* slots, const Row* rows, int* next, int n_rows,
                                      int live_groups) {
  const int per_row = 4 * live_groups;
  const int n_items = n_rows * per_row;
  const unsigned lane_id = threadIdx.x & 31u;
  const unsigned below = (1u << lane_id) - 1u;
  Lane L;
  L.item = -1;
  L.in_frac = false;
  bool need = true;
  while (true) {
    // Lanes without a quantile take the next ones, one atomicAdd a warp.
    const unsigned want = __ballot_sync(0xffffffffu, need);
    if (want != 0u) {
      const int leader = __ffs(want) - 1;
      int first = 0;
      if (static_cast<int>(lane_id) == leader) first = atomicAdd(next, __popc(want));
      first = __shfl_sync(0xffffffffu, first, leader);
      if (need) {
        const int item = first + __popc(want & below);
        L.item = item < n_items ? item : -1;
        if (L.item >= 0) {
          const int j = item / per_row;
          const int rest = item - j * per_row;
          const int lane = rest / live_groups;
          const int group = rest - lane * live_groups;
          const int sub = group / kThreads;
          L.slot = ((j * kGroups + sub) * 4 + lane) * kThreads + (group - sub * kThreads);
          L.row = j;
          L.q = slots[L.slot];
          const Row row = rows[L.row];
          const Args r = family_args<kFamilies>(row.family, L.q, row.s0, row.s1);
          L.kind = r.kind;
          L.a = r.a;
          L.b = r.b;
          L.p = r.p;
          L.lg0 = row.lg0;
          L.lg1 = row.lg1;
          start_item<kFamilies>(L);
          begin_trip<kFamilies>(L);
        }
        need = false;
      }
    }
    const unsigned alive = __ballot_sync(0xffffffffu, L.item >= 0);
    if (alive == 0u) break;
    const unsigned ready = __ballot_sync(0xffffffffu, L.item >= 0 && !L.in_frac);
    const int n_alive = __popc(alive), n_ready = __popc(ready);
    if (n_ready > 0 && n_ready >= min(kBatch, n_alive)) {
      if (L.item >= 0 && !L.in_frac) {
        if (end_trip<kFamilies>(L)) {
          const Row row = rows[L.row];
          slots[L.slot] = family_value<kFamilies>(row.family, L.q, inverse<kFamilies>(L), row.s0,
                                                  row.s1);
          L.item = -1;
          need = true;
        } else {
          begin_trip<kFamilies>(L);
        }
      }
    } else if (L.in_frac) {
      fraction_step<kFamilies>(L);
    }
  }
}

}  // namespace newton_ops
