"""Special functions for the inverse-CDF sampling path.

Port of ``probabilit_tpu/ops/special.py:44-205``: the Giles (2012)
single-precision inverse error function, the fast standard-normal
quantile built on it (and its wide-range form for derived quantiles),
and the Abramowitz & Stegun 7.1.26 normal CDF.  The device kernels
(``csrc/sampling_math.cuh``) transcribe the same coefficients, so the
plain and kernel paths compute the same functions.
"""

from __future__ import annotations

import torch

__all__ = ["erfinv_f32", "ndtri_fast", "ndtri_fast_wide", "ndtr_fast"]


def erfinv_f32(x):
    """Fast single-precision inverse error function (Giles 2012 scheme).

    Two short polynomial branches in w = -log(1-x^2).  w is clamped at
    16.64, the end of the tail branch's fit, so inputs that round to
    exactly +/-1 saturate at ~+/-4 with the correct sign.
    """
    x = x.to(torch.float32)
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-37))
    w = torch.clamp(w, max=16.64)
    p1, p2 = _giles_branch_polys(w)
    return torch.where(w < 5.0, p1, p2) * x


def _giles_branch_polys(w):
    """Giles (2012) erfinv polynomial branches evaluated at ``w``.

    Returns ``(p1, p2)``: the central branch (fit for w < 5) in
    ``w - 2.5`` and the tail branch in ``sqrt(w) - 3``.
    """
    wc = w - 2.5
    p1 = torch.full_like(w, 2.81022636e-08)
    p1 = 3.43273939e-07 + p1 * wc
    p1 = -3.5233877e-06 + p1 * wc
    p1 = -4.39150654e-06 + p1 * wc
    p1 = 0.00021858087 + p1 * wc
    p1 = -0.00125372503 + p1 * wc
    p1 = -0.00417768164 + p1 * wc
    p1 = 0.246640727 + p1 * wc
    p1 = 1.50140941 + p1 * wc

    ws = torch.sqrt(torch.clamp(w, max=16.64)) - 3.0
    p2 = torch.full_like(w, -0.000200214257)
    p2 = 0.000100950558 + p2 * ws
    p2 = 0.00134934322 + p2 * ws
    p2 = -0.00367342844 + p2 * ws
    p2 = 0.00573950773 + p2 * ws
    p2 = -0.0076224613 + p2 * ws
    p2 = 0.00943887047 + p2 * ws
    p2 = 1.00167406 + p2 * ws
    p2 = 2.83297682 + p2 * ws
    return p1, p2


_SQRT2 = 1.4142135623730951


def ndtri_fast(q):
    """Standard-normal quantile: the Giles path in float32, exact in float64.

    Valid for quantiles in [2^-24, 1 - 2^-24], the open-interval range the
    engine's generators produce (``qmc.clamp_open_unit``).
    """
    if q.dtype != torch.float32:
        return torch.special.ndtri(q)
    return _SQRT2 * erfinv_f32(2.0 * q - 1.0)


def ndtri_fast_wide(q):
    """Standard-normal quantile, accurate for q down to 1e-37 (float32).

    The same Giles branches as :func:`erfinv_f32`, but w = -log(4 q (1-q))
    is computed directly from q via log/log1p, so quantiles below ~3e-8
    do not collapse onto x = 2q - 1 = -1.  Beyond the Giles fit (w > 16.3)
    three fixed-point steps of the erfc asymptotic series take over.
    Exactly-0/1 inputs saturate at about +/-13 with the correct sign.
    """
    if q.dtype != torch.float32:
        return torch.special.ndtri(q)
    tail = torch.minimum(q, 1.0 - q)
    tail_c = torch.clamp(tail, min=1e-37)
    w = -(torch.log(tail_c) + torch.log1p(-tail_c) + 1.3862944)
    x = 2.0 * q - 1.0
    sign = torch.where(q >= 0.5, 1.0, -1.0).to(torch.float32)
    p1, p2 = _giles_branch_polys(w)

    # Far tail: y^2 = w + ln2 - ln(y sqrt(pi)) + log1p(-1/(2y^2) + 3/(4y^4)).
    y = torch.sqrt(w)
    for _ in range(3):
        inv2 = 1.0 / (2.0 * y * y)
        series = torch.log1p(-inv2 + 3.0 * inv2 * inv2)
        y = torch.sqrt(torch.clamp(w + 0.6931472 - 0.5723649 - torch.log(y) + series, min=1.0))

    erfinv = torch.where(w > 16.3, y * sign, torch.where(w < 5.0, p1 * x, p2 * x))
    return _SQRT2 * erfinv


def ndtr_fast(x):
    """Standard-normal CDF in float32 (Abramowitz & Stegun 7.1.26).

    The lower tail ``0.5 * poly(t) * exp(-z^2)`` is computed directly,
    never as ``1 - (something near 1)``, so it keeps relative accuracy
    for x << 0.  Other dtypes take ``torch.special.ndtr``.
    """
    if x.dtype != torch.float32:
        return torch.special.ndtr(x)
    z = torch.abs(x) * (1.0 / _SQRT2)
    t = 1.0 / (1.0 + 0.3275911 * z)
    tail = 0.5 * _as_tail_poly(t) * torch.exp(-z * z)
    return torch.where(x >= 0, 1.0 - tail, tail)


def _as_tail_poly(t):
    """A&S 7.1.26 erfc polynomial in ``t = 1/(1 + 0.3275911 z)``."""
    return t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
