"""Distribution node types for the modeling language.

Port of ``probabilit_tpu/models/distributions.py:41-325``: the abstract
sampling node, the parametric ``Distribution``, whose samples are the
inverse CDF (``ops/ppf.py``) of its quantile column, and the three table
nodes: ``EmpiricalDistribution`` (observed data), ``CumulativeDistribution``
(a piecewise-linear CDF) and ``DiscreteDistribution`` (values with
probabilities; non-numeric values are sampled as indices and gathered on
the host at the output).  Multivariate, marginal and copula nodes are
still to port (ROADMAP A8).
"""

from __future__ import annotations

import abc
import functools

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.models.graph import Node, OverloadMixin, Transform
from probabilit_tpu_torch.ops import ppf

__all__ = [
    "AbstractDistribution",
    "Distribution",
    "EmpiricalDistribution",
    "CumulativeDistribution",
    "DiscreteDistribution",
    "interp",
]


@functools.lru_cache(maxsize=None)
def _scipy_is_multivariate(name):
    return ppf.is_multivariate(name)


def _canonical_dtype(dtype):
    """The dtype the JAX package gives a numpy array of ``dtype`` (floats
    and integers at the configured width, as ``jnp.asarray`` does without
    x64 in float32 mode)."""
    dtype = np.dtype(dtype)
    wide = config.float_dtype() == torch.float64
    if dtype.kind == "f":
        return np.dtype(config.np_float_dtype())
    if dtype.kind == "i":
        return np.dtype(np.int64 if wide else np.int32)
    if dtype.kind == "u":
        return np.dtype(np.uint64 if wide else np.uint32)
    return dtype


def _linspace01(m, device):
    """``jnp.linspace(0, 1, m)`` in the float dtype, as XLA computes it:
    ``i * (1 / (m - 1))`` (the division by a constant becomes a multiply by
    its rounded reciprocal), and the endpoint exactly 1."""
    dtype = config.float_dtype()
    if m == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    one = torch.ones(1, dtype=dtype, device=device)
    steps = torch.arange(m - 1, dtype=dtype, device=device) * (one / (m - 1))
    return torch.cat([steps, one])


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: its formula and order of operations.

    ``i`` is ``searchsorted(xp, x, side="right")`` clipped to
    ``[1, len(xp) - 1]``; the value ``fp[i-1] + ((x - xp[i-1]) / dx) * df``,
    or ``fp[i-1]`` where ``|dx|`` is at most the spacing of the dtype's
    eps; then ``fp[0]`` left of ``xp[0]`` and ``fp[-1]`` right of ``xp[-1]``.
    XLA contracts the multiply-add into one fused operation; in float32 it
    is computed here in float64 and rounded once (the product is exact
    there), so the two packages agree to the last bit but where that
    double rounding differs, and in float64 to one ulp.
    """
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(config.np_float_dtype()).eps))
    dx0 = torch.abs(dx) <= epsilon
    ratio = delta / torch.where(dx0, 1.0, dx)
    if fp.dtype == torch.float32:
        line = (fp[i - 1].double() + ratio.double() * df.double()).float()
    else:
        line = fp[i - 1] + ratio * df
    f = torch.where(dx0, fp[i - 1], line)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class AbstractDistribution(Node, OverloadMixin, abc.ABC):
    """Base class for all sampling nodes; consumes one quantile column."""

    _is_distribution = True


class Distribution(AbstractDistribution):
    """A parametric distribution addressed by its scipy.stats name.

    Parameters may be numbers or other nodes (composite distributions).

    >>> Distribution("norm", loc=5, scale=1)
    Distribution("norm", loc=5, scale=1)
    """

    def __init__(self, distr, *args, **kwargs):
        self.distr = distr
        self.args = args
        self.kwargs = kwargs
        super().__init__()

    def __repr__(self):
        if Transform._repr_capped():
            return f'{type(self).__name__}("{self.distr}", ...)'
        with Transform._repr_frame():
            args = ", ".join(repr(arg) for arg in self.args)
            kwargs = ", ".join(f"{k}={repr(v)}" for (k, v) in self.kwargs.items())
        out = f'{type(self).__name__}("{self.distr}"'
        if args:
            out += f", {args}"
        if kwargs:
            out += f", {kwargs}"
        return out + ")"

    def get_parents(self):
        for arg in self.args + tuple(self.kwargs.values()):
            if isinstance(arg, Node):
                yield arg

    @property
    def is_leaf(self):
        return list(self.get_parents()) == []

    def _rewire(self, update):
        self.args = tuple(update(a) for a in self.args)
        self.kwargs = {k: update(v) for k, v in self.kwargs.items()}

    def _static_signature(self):
        sig_args = tuple("<node>" if isinstance(a, Node) else repr(a) for a in self.args)
        sig_kwargs = tuple(
            (k, "<node>" if isinstance(v, Node) else repr(v))
            for k, v in sorted(self.kwargs.items())
        )
        return ("Distribution", self.distr, sig_args, sig_kwargs)

    def _emit(self, ctx):
        if _scipy_is_multivariate(self.distr):
            raise NotImplementedError(
                f"Multivariate distribution {self.distr!r} is not ported yet "
                "(ROADMAP A8)."
            )
        q = ctx.column(self)

        def unpack(arg):
            return ctx.value(arg) if isinstance(arg, Node) else arg

        args = tuple(unpack(a) for a in self.args)
        kwargs = {k: unpack(v) for k, v in self.kwargs.items()}
        return ppf.call(self.distr, q, *args, **kwargs)


class EmpiricalDistribution(AbstractDistribution):
    """Inverse-CDF sampling from observed data, as ``np.quantile``.

    The default linear method interpolates the sorted data on the device
    (``interp`` on the grid ``linspace(0, 1, m)``); any other ``method=``
    is an exact ``np.quantile`` on the host, whose result dtype is probed
    on one quantile.
    """

    is_leaf = True

    def __init__(self, data, **kwargs):
        self.data = np.array(data)
        self.kwargs = kwargs
        super().__init__()

    def __repr__(self):
        return f"{type(self).__name__}()"

    def get_parents(self):
        yield from []

    def _static_signature(self):
        return (
            "EmpiricalDistribution",
            self.data.tobytes(),
            str(self.data.dtype),
            tuple(sorted((k, repr(v)) for k, v in self.kwargs.items())),
        )

    def _emit(self, ctx):
        q = ctx.column(self)
        method = self.kwargs.get("method", "linear")
        extra = {k: v for k, v in self.kwargs.items() if k != "method"}
        if method == "linear" and not extra and np.issubdtype(self.data.dtype, np.number):
            sorted_data = torch.from_numpy(
                np.asarray(np.sort(self.data), config.np_float_dtype())
            ).to(q.device)
            return interp(q, _linspace01(self.data.shape[0], q.device), sorted_data)
        try:
            probe = np.quantile(a=self.data, q=np.float64(0.5), **self.kwargs)
            out_dtype = _canonical_dtype(np.asarray(probe).dtype)
        except TypeError:
            out_dtype = np.dtype(config.np_float_dtype())
        exact = np.quantile(
            a=self.data, q=q.detach().cpu().numpy().astype(np.float64), **self.kwargs
        )
        return torch.from_numpy(np.asarray(exact, out_dtype)).to(q.device)


class CumulativeDistribution(AbstractDistribution):
    """A distribution given by a piecewise-linear CDF: ``quantiles`` (the
    probability levels, from 0 to 1) against ``cumulatives`` (the values).

    >>> distr = CumulativeDistribution([0, 0.2, 0.8, 1], [10, 15, 20, 25])
    """

    is_leaf = True

    def __init__(self, quantiles, cumulatives):
        self.q = np.array(quantiles)
        self.cumulatives = np.array(cumulatives)
        if not np.all(np.diff(self.q) > 0):
            raise ValueError("quantiles must form a strictly increasing sequence.")
        if not np.all(np.diff(self.cumulatives) > 0):
            raise ValueError(
                "cumulatives must form a strictly increasing sequence "
                "(a CDF table cannot have flat or decreasing segments)."
            )
        if not (np.isclose(np.min(self.q), 0) and np.isclose(np.max(self.q), 1)):
            raise ValueError(
                "Lowest quantile level must be 0 and the highest 1 (the "
                "table must span the whole CDF)."
            )
        super().__init__()

    def __repr__(self):
        return (
            f"{type(self).__name__}(quantiles={repr(self.q)}, "
            f"cumulatives={repr(self.cumulatives)})"
        )

    def get_parents(self):
        yield from []

    def _static_signature(self):
        return ("CumulativeDistribution", self.q.tobytes(), self.cumulatives.tobytes())

    def _emit(self, ctx):
        q = ctx.column(self)
        dtype = config.np_float_dtype()
        xp = torch.from_numpy(np.asarray(self.q, dtype)).to(q.device)
        fp = torch.from_numpy(np.asarray(self.cumulatives, dtype)).to(q.device)
        return interp(q, xp, fp)


class DiscreteDistribution(AbstractDistribution):
    """A discrete distribution over ``values`` with ``probabilities``
    (uniform by default).

    Sampling is ``searchsorted(cumsum(probabilities), q, side="right")``,
    clamped to the last index, then a gather of the values; numeric values
    keep their integer dtype (int32 in float32 mode, as ``jnp.take``
    gives).  Non-numeric values (strings) cannot live on the device: the
    indices are sampled there and ``_host_finalizer`` gathers the values on
    the host at the output.
    """

    is_leaf = True

    def __init__(self, values, probabilities=None):
        self.values = np.array(values)
        if probabilities is None:
            self.probabilities = np.ones(len(self.values), dtype=float)
            self.probabilities = self.probabilities / np.sum(self.probabilities)
        else:
            self.probabilities = np.array(probabilities)
        if not len(self.values) == len(self.probabilities):
            raise ValueError(
                f"Length mismatch: {len(self.values)=}  {len(self.probabilities)=}"
            )
        if not np.isclose(np.sum(self.probabilities), 1.0):
            raise ValueError(f"Probabilities must sum to 1. {sum(self.probabilities)=}")
        if np.any(self.probabilities < 0):
            raise ValueError("Probabilities are not non-negative.")
        super().__init__()

    def __repr__(self):
        return (
            f"{type(self).__name__}(values={repr(self.values)}, "
            f"probabilities={repr(self.probabilities)})"
        )

    def get_parents(self):
        yield from []

    def _static_signature(self):
        return (
            "DiscreteDistribution",
            # tolist(), not repr(array): numpy shortens the repr of long arrays.
            self.values.tobytes()
            if self.values.dtype != object
            else repr(self.values.tolist()),
            str(self.values.dtype),
            self.probabilities.tobytes(),
        )

    def _emit(self, ctx):
        q = ctx.column(self)
        cumulative = torch.from_numpy(
            np.asarray(np.cumsum(self.probabilities), config.np_float_dtype())
        ).to(q.device)
        idx = torch.clamp(
            torch.searchsorted(cumulative, q.contiguous(), right=True), max=len(self.values) - 1
        )
        if np.issubdtype(self.values.dtype, np.number):
            values = np.ascontiguousarray(self.values, _canonical_dtype(self.values.dtype))
            return torch.from_numpy(values).to(q.device)[idx]
        return idx.to(config.int_dtype())

    def _host_finalizer(self):
        """The host gather of non-numeric values, or None for numbers."""
        if np.issubdtype(self.values.dtype, np.number):
            return None
        values = self.values

        def gather(idx):
            if isinstance(idx, torch.Tensor):
                idx = idx.cpu().numpy()
            return values[np.asarray(idx)]

        return gather
