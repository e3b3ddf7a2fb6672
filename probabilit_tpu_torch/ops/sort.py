"""Row-wise sorts and permutations for Iman-Conover.

Port of ``probabilit_tpu/ops/sort.py:49-117``.  On the TPU a scatter
costs several times a sort, so the JAX package applies and inverts
permutations as integer-key variadic sorts.  On the GPU a scatter is one
cheap pass, so here a permutation is applied with ``Tensor.scatter``
after one ``torch.sort``.  The JAX package also cuts its sorts into row
chunks to bound the TPU's sort workspace; the port does not: at the
largest shape of the main path, (10, 1e8) float32, one ``torch.sort``
holds 4 GB of values and 8 GB of int64 indices, which an 80 GB card
holds whole.
"""

from __future__ import annotations

import torch

__all__ = [
    "rowsort_with_order",
    "apply_inverse_permutation_rows",
    "invert_permutation",
]


def rowsort_with_order(XT, stable=False):
    """Sort each ROW of ``XT`` (K, N); returns ``(sorted, order)``.

    ``stable=True`` keeps tied values in position order, which ordinal
    ranks promise; average ranks are tie-order independent.
    """
    return torch.sort(XT, dim=1, stable=stable)


def apply_inverse_permutation_rows(order, payload):
    """Row-wise "unsort": ``out[k, order[k, j]] = payload[k, j]``."""
    return torch.empty_like(payload).scatter_(1, order, payload)


def invert_permutation(order):
    """Per-column inverse permutation of an (N, K) ``order``:
    ``inv[order[j, k], k] = j``."""
    iota = torch.arange(order.shape[0], device=order.device).expand(order.shape[1], -1)
    return apply_inverse_permutation_rows(order.T, iota.contiguous()).T
