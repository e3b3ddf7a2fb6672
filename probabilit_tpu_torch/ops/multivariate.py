"""Samplers of multivariate distributions, in PyTorch.

Port of ``probabilit_tpu/ops/multivariate.py``.  A multivariate node
consumes one quantile column, as in the reference library, and its draws
come from a generator keyed by that column (``_key_from_q``): the float32
bits of its first two values.  The JAX package folds them into a jax key,
which cannot be reproduced; here they seed a ``torch.Generator`` on the
column's device, so the draws are reproducible per ``random_state`` and
differ from the JAX package's by design.  Reading the two values is one
host read per node and call.

The multivariate normal, Dirichlet and multinomial sample on the device;
any other scipy multivariate family goes through scipy's ``rvs`` on the
host (``ops.ppf.scipy_fallback_rvs``).
"""

from __future__ import annotations

import numpy as np
import torch

from probabilit_tpu_torch import config

__all__ = ["lookup", "multivariate_normal", "dirichlet", "multinomial"]

_REGISTRY = {}
_KEY_SALT = 0x51D5EED


def _register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def lookup(name):
    return _REGISTRY.get(name)


def _key_from_q(q, salt=_KEY_SALT):
    """A ``torch.Generator`` on ``q``'s device, keyed by the float32 bits of
    the column's first two values (the second is the first for a column of
    one): about 2^48 distinct keys, so streamed blocks do not collide.
    ``salt`` (an int or a tuple of ints) separates the streams of users of
    one column.  One host read."""
    q32 = q.reshape(-1)[:2].to(torch.float32).contiguous()
    bits = q32.view(torch.int32).cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    b0, b1 = int(bits[0]), int(bits[-1])
    words = np.random.SeedSequence(salt, spawn_key=(b0, b1)).generate_state(2, np.uint32)
    gen = torch.Generator(device=q.device)
    gen.manual_seed(int(words[0]) | int(words[1]) << 32)
    return gen


def _tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)


@_register("multivariate_normal")
def multivariate_normal(q, shape, mean=None, cov=None, **_):
    n, d = shape
    dtype, device = config.float_dtype(), q.device
    mean = torch.zeros((d,), dtype=dtype, device=device) if mean is None else _tensor(mean, dtype, device)
    cov = torch.eye(d, dtype=dtype, device=device) if cov is None else _tensor(cov, dtype, device)
    L = torch.linalg.cholesky(cov)
    z = torch.randn((n, d), generator=_key_from_q(q), dtype=dtype, device=device)
    return mean + z @ L.T


@_register("dirichlet")
def dirichlet(q, shape, alpha, **_):
    n, d = shape
    alpha = _tensor(alpha, config.float_dtype(), q.device)
    return torch._sample_dirichlet(alpha.expand(n, d).contiguous(), generator=_key_from_q(q))


@_register("multinomial")
def multinomial(q, shape, n=1, p=None, **_):
    """Counts of ``n`` categorical draws per row, each the inverse CDF of a
    uniform over the cumulative probabilities."""
    rows, d = shape
    dtype, device = config.float_dtype(), q.device
    p = np.full(d, 1.0 / d) if p is None else p
    cumulative = torch.cumsum(_tensor(p, torch.float64, device), 0)
    cumulative = (cumulative / cumulative[-1]).to(dtype)
    u = torch.rand((rows, int(n)), generator=_key_from_q(q), dtype=dtype, device=device)
    draws = torch.clamp(torch.searchsorted(cumulative, u, right=True), max=d - 1)
    counts = torch.zeros((rows, d), dtype=dtype, device=device)
    return counts.scatter_add_(1, draws, torch.ones_like(u))
