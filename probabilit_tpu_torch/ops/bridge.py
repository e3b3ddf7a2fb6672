"""Brownian-bridge construction for quasi-Monte-Carlo path sampling.

Port of ``probabilit_tpu/ops/bridge.py``.  QMC sequences are most
accurate in their leading dimensions, while a path's statistical mass
lies in a few coarse features (terminal level, then midpoint, then the
quarter points, ...).  The bridge aligns the two: dimension 0 drives the
terminal value, dimension 1 the midpoint given it, and so on coarse to
fine.

The construction is linear, so it is one precomputed ``(steps, steps)``
matrix applied as one product:

* ``bridge_matrix(steps)`` -- ``B`` with ``W = z @ B.T`` a standard
  Brownian motion on the grid ``t_k = k + 1`` when ``z`` is iid standard
  normal, ``z[:, 0]`` mapped to the terminal point and later columns to
  midpoints in breadth-first order.
* ``increment_matrix(steps)`` -- ``A = diff(B)`` (first row kept), an
  orthogonal matrix: ``z @ A.T`` are iid standard normals whose
  cumulative sum is ``W``.  Path nodes consume increments, so they apply
  ``A``; orthogonality keeps the law of the increments exact.

The matrices are built once per ``steps`` on the host in float64 and
cached (the JAX package's numpy code, copied).  The product runs with
TF32 off (``correlation._full_float32``), as the correlators' do: a TF32
product would round each operand to 10 mantissa bits (the JAX package
pins float32 precision against the TPU's bfloat16 passes).  On one H100
its rows are the same whatever the batch (a 2^18-row product against its
2^16-row blocks, bitwise), which a streamed ``method=`` run relies on.
"""

from __future__ import annotations

import functools
from collections import deque

import numpy as np
import torch

__all__ = ["bridge_matrix", "increment_matrix", "normal_increments"]


@functools.lru_cache(maxsize=64)
def _bridge_matrix_np(steps):
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}.")
    # Rows are grid points 0..steps at unit-spaced times; row 0 is the
    # deterministic start W(0) = 0.
    B = np.zeros((steps + 1, steps), dtype=np.float64)
    B[steps, 0] = np.sqrt(float(steps))
    k = 1
    # Breadth-first midpoint refinement, each midpoint conditioned on its
    # interval's endpoints: W_m | W_l, W_r ~ N(a W_l + b W_r,
    # (m-l)(r-m)/(r-l)), exact for any steps.
    queue = deque([(0, steps)])
    while queue:
        lo, hi = queue.popleft()
        if hi - lo < 2:
            continue
        mid = (lo + hi) // 2
        a = (hi - mid) / (hi - lo)
        b = (mid - lo) / (hi - lo)
        s = np.sqrt((mid - lo) * (hi - mid) / (hi - lo))
        B[mid] = a * B[lo] + b * B[hi]
        B[mid, k] = s
        k += 1
        queue.append((lo, mid))
        queue.append((mid, hi))
    assert k == steps
    return B[1:]


def bridge_matrix(steps):
    """``(steps, steps)`` float64 ``B``: ``W = z @ B.T`` is standard BM on
    the grid ``1, 2, ..., steps``; ``z[:, 0]`` sets the terminal point.

    >>> B = bridge_matrix(4)
    >>> (B @ B.T).round(10)[0]      # cov(W_i, W_j) = min(t_i, t_j)
    array([1., 1., 1., 1.])
    """
    return _bridge_matrix_np(int(steps)).copy()


@functools.lru_cache(maxsize=64)
def _increment_matrix_np(steps):
    B = _bridge_matrix_np(int(steps))
    return np.diff(B, axis=0, prepend=np.zeros((1, B.shape[1])))


def increment_matrix(steps):
    """Orthogonal ``(steps, steps)`` float64 ``A``: bridge-ordered z ->
    iid standard-normal increments (``cumsum(z @ A.T, axis=1) = W``).

    >>> A = increment_matrix(8)
    >>> bool(np.abs(A @ A.T - np.eye(8)).max() < 1e-12)
    True
    """
    return _increment_matrix_np(int(steps)).copy()


def normal_increments(u, dtype):
    """Bridge-ordered uniform slab ``(n, steps)`` -> iid N(0, 1) increments.

    One inverse normal CDF and one ``(n, steps) @ (steps, steps)`` product
    (TF32 off).  ``u[:, 0]`` controls the terminal point of the underlying
    Brownian path; ``A`` is orthogonal, so the output is exactly iid
    standard normal in law.
    """
    from probabilit_tpu_torch.ops import special as _special
    from probabilit_tpu_torch.ops.correlation import _full_float32

    z = _special.ndtri_fast(u.to(dtype))
    steps = u.shape[-1]
    if steps == 1:
        return z
    A = torch.as_tensor(_increment_matrix_np(steps), dtype=dtype, device=z.device)
    with _full_float32():
        return z @ A.T
