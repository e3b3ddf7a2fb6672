"""Direct generation of sorted uniforms (order statistics).

Port of ``probabilit_tpu/ops/orderstats.py``.  If E_1..E_{n+1} are iid
Exp(1), ``cumsum(E_1..E_n) / sum(E_1..E_{n+1})`` is distributed exactly
as the order statistics of n iid U(0, 1) draws: a sorted uniform sample
with no sort (the generation half of ``ImanConover._apply_generated``).

float32: a flat cumsum over 1e8 terms carries O(sum * 2^-24) rounding,
far more than the ~1/n spacing, so the cumsum is two-level: within
4096-element blocks, plus a prefix of the block totals.
"""

from __future__ import annotations

import torch

from probabilit_tpu_torch import config

__all__ = ["sorted_uniforms"]

_BLOCK = 4096


def sorted_uniforms(generator, rows, n, dtype=torch.float32):
    """(rows, n) matrix whose rows are sorted U(0, 1) order statistics,
    drawn from ``generator`` on its device."""
    device = generator.device if generator is not None else config.device()
    blocks = -(-(n + 1) // _BLOCK)
    padded = blocks * _BLOCK
    lo = 2.0**-24
    u = torch.rand((rows, blocks, _BLOCK), generator=generator, dtype=dtype, device=device)
    e = -torch.log(lo + (1.0 - lo) * u)
    # Entries beyond n + 1 are masked, so the total uses exactly n + 1 draws.
    idx = torch.arange(padded, device=device).reshape(blocks, _BLOCK)
    e = torch.where(idx[None] < n + 1, e, torch.zeros((), dtype=dtype, device=device))
    within = torch.cumsum(e, dim=-1)
    block_totals = within[:, :, -1]
    offsets = torch.cumsum(block_totals, dim=-1) - block_totals
    flat = (within + offsets[:, :, None]).reshape(rows, padded)
    total = flat[:, n]  # the cumsum through the (n+1)-th exponential
    out = flat[:, :n] * (1.0 / total)[:, None]
    tiny = 2.0**-24 if dtype == torch.float32 else 2.0**-53
    return torch.clamp(out, tiny, 1.0 - tiny)
