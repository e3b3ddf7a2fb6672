"""K1's table rows in PyTorch: what ``csrc/table_ops.cuh`` computes per lane.

A table row of the generated kernel counts the boundaries of its table
below its quantile q (``TABLE_CDF``: ``b < q``) or at or below it
(``TABLE_DISCRETE``, ``TABLE_INTERP``: ``b <= q``) and gathers the value
at that count.  With a guide (``cuda_exec.table_guide``: M cells, a
window of W) it reads the word of cell ``floor(q M)``, clamped to [0, M)
(a NaN q reads cell 0, as the card's ``cvt.rzi`` gives 0), and searches
the W boundaries from the word, or the whole table where the word is
negative (``guided_count``); without one it runs the branch-free search
over all NB boundaries (``full_count``).  This module transcribes both on
float32 tensors, step for step, and counts each lane's loads after the
guide's word; ``warp_wavefronts`` prices a row at least: the guide's
word, each path a warp's lanes take (once for the warp), the gather
(``GATHER_WAVEFRONTS``).

The tests hold the counts and values to ``torch.searchsorted``, to the
twin's rows (``cuda_exec._table_row``) and to the JAX package's select
trees, bitwise; ``chip_smoke.py`` prices the kernel's table rows by these
counts.  Nothing on the sampling path calls this module.
"""

from __future__ import annotations

import torch

__all__ = ["GATHER_WAVEFRONTS", "cell_of", "full_count", "guided_count", "lookup",
           "warp_wavefronts"]

# A warp's shared-memory wavefronts for the gather after the count, at
# least: a Discrete's value (one word a lane), an interval's float4 leaf
# (512 bytes a warp, four wavefronts of 128) and the right end's (one
# address for every lane).  A CDF table's count is its result.
GATHER_WAVEFRONTS = {"TABLE_CDF": 0, "TABLE_DISCRETE": 1, "TABLE_INTERP": 5}

_STRICT = {"TABLE_CDF": True, "TABLE_DISCRETE": False, "TABLE_INTERP": False}


def _below(v, q, strict):
    return v < q if strict else v <= q


def cell_of(q, cells):
    """The guide's cell of each float32 quantile: ``floor(q * cells)``
    clamped to [0, cells) (``q * cells`` is exact, cells a power of two),
    0 for NaN."""
    x = torch.nan_to_num(q.to(torch.float32) * float(cells), nan=0.0)
    return x.clamp(0.0, float(cells - 1)).to(torch.int64)


def _search(bounds, base, n, q, strict):
    """``Search<n, kStrict>::count(b, base, q)``: (base plus the count of
    ``bounds[base .. base + n)`` below ``q``, the loads a lane takes)."""
    loads = 0
    while n > 1:
        half = n // 2
        base = torch.where(_below(bounds[base + half], q, strict), base + half, base)
        n -= half
        loads += 1
    if n == 1:
        base = base + _below(bounds[base], q, strict).to(torch.int64)
        loads += 1
    return base, torch.full_like(base, loads)


def full_count(bounds, q, strict):
    """The full search, ``Search<NB, kStrict>::count(b, 0, q)``: (the count
    of the sorted float32 ``bounds`` below ``q``, the loads a lane takes,
    the same for every lane)."""
    zero = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    return _search(bounds, zero, len(bounds), q, strict)


def guided_count(bounds, words, cells, window, q, strict):
    """``guided_count<NB, kStrict>``: (the count of the sorted float32
    ``bounds`` below ``q``, the loads each lane takes after the guide's
    word) through the guide ``words`` (int64 from the int32 words,
    ``cells`` of them): the window of ``window`` boundaries the cell's word
    starts, or the full search where the word is negative (a crowded
    cell)."""
    word = words[cell_of(q, cells)]
    crowded = word < 0
    count, loads = _search(bounds, torch.where(crowded, 0, word), window, q, strict)
    full, full_loads = full_count(bounds, q, strict)
    return torch.where(crowded, full, count), torch.where(crowded, full_loads, loads)


def warp_wavefronts(name, steps, guided):
    """The shared-memory wavefronts a sample takes, at least, for a table
    row whose lanes' search loads after the guide are ``steps`` (in sample
    order: four lanes a thread, 32 threads a warp, so each of a warp's
    four lookups covers 32 samples): the guide's word (``guided``), each
    path its lanes take (the window's steps and the full search's) once
    for the warp, and the gather."""
    groups = steps.reshape(-1, 32, 4).transpose(1, 2).reshape(-1, 32)
    paths = sum(int(v) * int((groups == v).any(dim=1).sum()) for v in torch.unique(steps))
    return paths / steps.numel() + (int(guided) + GATHER_WAVEFRONTS[name]) / 32


def lookup(name, tables, offset, nb, q, guide=None):
    """A table row of the kernel: (its float32 value, the loads of each
    lane's search after the guide's word) on ``tables`` (a tape's float32
    tables) at ``offset`` with ``nb`` boundaries, for the float32 quantiles
    ``q``; ``guide`` is ``(its offset in tables, cells, window)``, or None
    for the full search.  The value is ``cuda_exec._table_row``'s,
    bitwise."""
    bounds = tables[offset : offset + nb]
    data = tables[offset + (-(-nb // 4) * 4) :]
    strict = _STRICT[name]
    if guide is None:
        count, steps = full_count(bounds, q, strict)
    else:
        start, cells, window = guide
        words = tables[start : start + cells].contiguous().view(torch.int32).to(torch.int64)
        count, steps = guided_count(bounds, words, cells, window, q, strict)
    if name == "TABLE_CDF":
        return torch.where(torch.isnan(q), q, count.to(torch.float32)), steps
    if name == "TABLE_DISCRETE":
        return torch.where(torch.isnan(q), q, data[count]), steps
    leaf = data[: 4 * (nb + 1)].reshape(nb + 1, 4)[count]
    value = leaf[:, 1] + (q - leaf[:, 0]) * leaf[:, 2]
    x_last, f_last = data[4 * (nb + 1)], data[4 * (nb + 1) + 1]
    return torch.where(q >= x_last, f_last, value), steps
