"""Special functions for the inverse-CDF sampling path.

Port of ``probabilit_tpu/ops/special.py:44-116``: the Giles (2012)
single-precision inverse error function and the fast standard-normal
quantile built on it.  The device kernel (``csrc/graph_megakernel.cu``)
transcribes the same coefficients, so the plain and kernel paths compute
the same function.
"""

from __future__ import annotations

import torch

__all__ = ["erfinv_f32", "ndtri_fast"]


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
