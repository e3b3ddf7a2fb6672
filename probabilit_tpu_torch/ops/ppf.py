"""Inverse-CDF (ppf) functions per distribution family, in PyTorch.

Port of ``probabilit_tpu/ops/ppf.py:54-222`` for the five closed-form
families of the flagship graph: ``uniform``, ``norm``, ``expon``,
``lognorm`` and ``triang``.  Each is ``ppf(q, *shape_params, loc, scale)``
with scipy.stats' parameter names and order.  Parameters may be tensors
(composite distributions) or numbers; both broadcast elementwise.  The
other families of the reference (Newton, table and scipy-callback tiers)
are still to port (ROADMAP A8).

The score shortcuts (``score_call``, ``score_emit``) evaluate
``ppf(ndtr(y))`` in closed form for the score-linear families (norm,
lognorm), as ``probabilit_tpu/ops/ppf.py:151-190`` does for the
correlated paths.
"""

from __future__ import annotations

import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.ops import special

__all__ = ["register", "lookup", "call", "score_call", "score_emit"]

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def lookup(name):
    return _REGISTRY.get(name)


def call(name, q, *args, **kwargs):
    """Evaluate the ppf of scipy.stats distribution ``name`` at ``q``."""
    kernel = lookup(name)
    if kernel is None:
        raise NotImplementedError(
            f"Distribution family {name!r} is not ported yet; the port "
            "samples uniform, norm, expon, lognorm and triang "
            "(other families: ROADMAP A8)."
        )
    return kernel(q, *args, **kwargs)


def _f(x):
    """Promote a parameter to the configured float dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(config.float_dtype())
    return torch.tensor(x, dtype=config.float_dtype())


@register("uniform")
def uniform(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * _f(q)


@register("norm")
def norm(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.ndtri_fast(_f(q))


@register("expon")
def expon(q, loc=0.0, scale=1.0):
    return _f(loc) - _f(scale) * torch.log1p(-_f(q))


@register("lognorm")
def lognorm(q, s, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.exp(_f(s) * special.ndtri_fast(_f(q)))


@register("triang")
def triang(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    left = torch.sqrt(q * c)
    right = 1.0 - torch.sqrt((1.0 - q) * (1.0 - c))
    x = torch.where(q <= c, left, right)
    return _f(loc) + _f(scale) * x


# Normal-score shortcuts: families whose ppf is an elementwise function
# of ndtri(q) have a closed form in a standard-normal score y,
# ppf(ndtr(y)) = g(y).  The correlated paths produce such scores, so g(y)
# skips the ndtr/ndtri roundtrip (exact where the roundtrip drifts in the
# tails).


def _score_norm(y, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * _f(y)


def _score_lognorm(y, s, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.exp(_f(s) * _f(y))


_SCORE_KERNELS = {"norm": _score_norm, "lognorm": _score_lognorm}


def score_call(name, y, *args, **kwargs):
    """``ppf(name, ndtr(y))`` in closed form, or None if unsupported."""
    kernel = _SCORE_KERNELS.get(name)
    return None if kernel is None else kernel(y, *args, **kwargs)


def score_emit(var, y, ctx):
    """Score shortcut for a ``Distribution`` node, or None.

    Node-valued parameters resolve through ``ctx`` exactly as in
    ``Distribution._emit``.
    """
    from probabilit_tpu_torch.models.distributions import Distribution
    from probabilit_tpu_torch.models.graph import Node

    if not isinstance(var, Distribution) or var.distr not in _SCORE_KERNELS:
        return None

    def unpack(a):
        return ctx.value(a) if isinstance(a, Node) else a

    args = tuple(unpack(a) for a in var.args)
    kwargs = {k: unpack(v) for k, v in var.kwargs.items()}
    return score_call(var.distr, y, *args, **kwargs)
