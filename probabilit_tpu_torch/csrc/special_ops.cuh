// special_ops.cuh: the special functions of the megakernel's family ops.
//
// Each function transcribes its plain PyTorch twin in ops/special.py under
// kernel_safe_special (the functions the TPU kernel lowers): the wide-range
// normal quantile (the Newton tier's guesses; the closed forms take
// fast_math.cuh's), the Lanczos log-gamma and the series and
// continued-fraction incomplete gamma (argus's normaliser).  Where the
// twin evaluates both branches of a select (the series and the continued
// fraction) these evaluate only the branch the lane takes: the value is
// the same.  The Newton inverses of the incomplete gamma and beta
// functions are newton_ops.cuh's.
//
// Division and libm calls are IEEE (no fast-math flags); the compiler may
// contract a multiply and an add into an FMA where the twin rounds twice.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"

namespace special_ops {

constexpr float kTiny = 1e-30f;

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

}  // namespace special_ops
