"""Quasi-Monte Carlo helpers; only the open-interval clamp is ported so far.

Counterpart of ``probabilit_tpu/ops/qmc.py:195-205``.  Sobol, Halton, LHS
and antithetic sequences are still to port (ROADMAP A9).
"""

from __future__ import annotations

import torch

__all__ = ["clamp_open_unit"]


def clamp_open_unit(q):
    """Clamp quantiles into the OPEN interval (0, 1).

    A float32 uniform on [0, 1) hits exactly 0 about once per 2^24 draws,
    which an unbounded inverse CDF maps to -inf.  The clamp moves each
    endpoint by one step of the generator's grid: 2^-24 in float32,
    2^-53 in float64.
    """
    tiny = 2.0**-24 if q.dtype == torch.float32 else 2.0**-53
    return torch.clamp(q, tiny, 1.0 - tiny)
