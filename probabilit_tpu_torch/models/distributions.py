"""Distribution node types for the modeling language.

Port of ``probabilit_tpu/models/distributions.py:41-325``: the abstract
sampling node, the parametric ``Distribution``, whose samples are the
inverse CDF (``ops/ppf.py``) of its quantile column, and the three table
nodes: ``EmpiricalDistribution`` (observed data), ``CumulativeDistribution``
(a piecewise-linear CDF) and ``DiscreteDistribution`` (values with
probabilities; non-numeric values are sampled as indices and gathered on
the host at the output); and (``:107-139``, ``:328-659``) the
multivariate ``Distribution`` with its ``MarginalDistribution`` slices,
the copula nodes (``CopulaDistribution``, ``EllipticalCopulaDistribution``,
``EmpiricalCopulaDistribution``), whose (n, d) draws come from a
generator keyed by the node's quantile column (``ops/multivariate.py``),
and ``QuantileTransform``, which pushes a (0, 1)-valued node through a
family's wide-range inverse CDF.
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
    "MarginalDistribution",
    "MultivariateDistribution",
    "CopulaDistribution",
    "EllipticalCopulaDistribution",
    "EmpiricalCopulaDistribution",
    "QuantileTransform",
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

    def _mv_dim(self):
        """Event dimension of a multivariate distribution (scipy draws one
        event once, on the host)."""
        if not hasattr(self, "_mv_dim_cache"):
            import scipy.stats as sps

            frozen = getattr(sps, self.distr)(*self.args, **self.kwargs)
            draw = np.atleast_2d(np.asarray(frozen.rvs(size=1, random_state=0)))
            self._mv_dim_cache = draw.shape[-1]
        return self._mv_dim_cache

    def _emit(self, ctx):
        q = ctx.column(self)

        def unpack(arg):
            return ctx.value(arg) if isinstance(arg, Node) else arg

        args = tuple(unpack(a) for a in self.args)
        kwargs = {k: unpack(v) for k, v in self.kwargs.items()}
        if _scipy_is_multivariate(self.distr):
            # (n, d) draws from a generator keyed by the column: the
            # multivariate normal, Dirichlet and multinomial on the device,
            # any other family through scipy's rvs on the host.
            from probabilit_tpu_torch.ops import multivariate as mv

            shape = (ctx.n, self._mv_dim())
            native = mv.lookup(self.distr)
            if native is not None:
                return native(q, shape, *args, **kwargs)
            return ppf.scipy_fallback_rvs(self.distr, q, shape, *args, **kwargs)
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


class CopulaDistribution(AbstractDistribution):
    """(n, d) draws with uniform marginals and an Archimedean copula's
    dependence.  Unpack through ``MarginalDistribution`` slices (the
    ``ClaytonCopula`` / ``GumbelCopula`` / ``FrankCopula`` factories), then
    shape each marginal with ``QuantileTransform``.

    The node consumes one quantile column and draws from a generator keyed
    by it (``ops/multivariate._key_from_q``).

    >>> CopulaDistribution("clayton", theta=2.0, d=3)
    CopulaDistribution("clayton", theta=2, d=3)
    """

    is_leaf = True
    # (n, d)-valued: cannot join a correlate() declaration (Plan checks).
    _vector_valued = True
    # Its randomness comes from a column-keyed generator: a streamed
    # method= run refuses the graph.
    _key_seeded = True

    def __init__(self, family, theta, d):
        from probabilit_tpu_torch.ops import copulas

        theta, d = copulas.validate(family, theta, d)
        self.family = str(family)
        self.theta = theta
        self.d = d
        super().__init__()

    def __repr__(self):
        return f'{type(self).__name__}("{self.family}", theta={self.theta:g}, d={self.d})'

    def get_parents(self):
        return iter(())

    def _rewire(self, update):
        pass

    def _static_signature(self):
        return ("CopulaDistribution", self.family, self.theta, self.d)

    def _mv_dim(self):
        return self.d

    def _emit(self, ctx):
        from probabilit_tpu_torch.ops import copulas
        from probabilit_tpu_torch.ops import multivariate as mv

        q = ctx.column(self)
        return copulas.sample(
            self.family, mv._key_from_q(q), (ctx.n, self.d), self.theta,
            config.float_dtype(), q.device,
        )


class MarginalDistribution(Transform):
    """A 'slice' of a multivariate distribution.

    >>> distr = Distribution("multinomial", n=10, p=[0.1, 0.2, 0.7])
    >>> MarginalDistribution(distr, d=0)
    MarginalDistribution(Distribution("multinomial", n=10, p=[0.1, 0.2, 0.7]), d=0)
    """

    is_leaf = False

    def __init__(self, distr, d):
        self.distr = distr
        self.d = d
        super().__init__()

    def get_parents(self):
        yield self.distr

    def _rewire(self, update):
        self.distr = update(self.distr)

    def __repr__(self):
        return f"{type(self).__name__}({self.distr}, d={self.d})"

    def _static_signature(self):
        return ("MarginalDistribution", self.d)

    def _emit(self, ctx):
        return torch.atleast_2d(ctx.value(self.distr))[:, self.d]


class EllipticalCopulaDistribution(AbstractDistribution):
    """(n, d) uniform-marginal draws with Gaussian or Student-t dependence
    (a shape matrix and, for the t, ``df``); use the ``GaussianCopula`` /
    ``TCopula`` factories.  Keyed by its column as ``CopulaDistribution``."""

    is_leaf = True
    _vector_valued = True
    _key_seeded = True

    def __init__(self, family, corr, df=None):
        from probabilit_tpu_torch.ops import copulas

        chol, d, df = copulas.validate_elliptical(family, corr, df)
        self.family = str(family)
        self.corr = np.asarray(corr, np.float64)
        self._chol = chol
        self.df = df
        self.d = d
        super().__init__()

    def __repr__(self):
        extra = "" if self.df is None else f", df={self.df:g}"
        return f'{type(self).__name__}("{self.family}", d={self.d}{extra})'

    def get_parents(self):
        return iter(())

    def _rewire(self, update):
        pass

    def _static_signature(self):
        return ("EllipticalCopulaDistribution", self.family, self.corr.tobytes(), self.df)

    def _mv_dim(self):
        return self.d

    def _emit(self, ctx):
        from probabilit_tpu_torch.ops import copulas
        from probabilit_tpu_torch.ops import multivariate as mv

        q = ctx.column(self)
        return copulas.elliptical_sample(
            self.family, mv._key_from_q(q), ctx.n, self._chol, self.df,
            config.float_dtype(), q.device,
        )


class EmpiricalCopulaDistribution(AbstractDistribution):
    """(n, d) draws with the empirical dependence of observed data: rows of
    its rank pseudo-observations ``rank/(m+1)``, bootstrapped.  Use the
    ``EmpiricalCopula`` factory.  Keyed by its column as
    ``CopulaDistribution``."""

    is_leaf = True
    _vector_valued = True
    _key_seeded = True

    def __init__(self, data):
        from probabilit_tpu_torch.ops import copulas

        self.pseudo = copulas.empirical_pseudo_observations(data)
        self.d = self.pseudo.shape[1]
        super().__init__()

    def __repr__(self):
        return f"{type(self).__name__}(m={self.pseudo.shape[0]}, d={self.d})"

    def get_parents(self):
        return iter(())

    def _rewire(self, update):
        pass

    def _static_signature(self):
        return ("EmpiricalCopulaDistribution", self.pseudo.tobytes())

    def _mv_dim(self):
        return self.d

    def _emit(self, ctx):
        from probabilit_tpu_torch.ops import copulas
        from probabilit_tpu_torch.ops import multivariate as mv

        q = ctx.column(self)
        return copulas.empirical_sample(
            mv._key_from_q(q), ctx.n, self.pseudo, config.float_dtype(), q.device
        )


class QuantileTransform(Transform):
    """Push a (0, 1)-valued node through a named family's inverse CDF.

    Turns a copula marginal, a computed probability or a rank statistic
    into draws from a scipy.stats family.  Parameters may be numbers or
    nodes.  Values are clamped to the open unit interval at the float's
    normal-range floor (``ops/qmc.clamp_open_unit_wide``), not the 2^-24
    grid, and families with a wide ppf (norm, lognorm: ``ppf.call_wide``)
    resolve them down to ~1e-37 in float32.

    >>> QuantileTransform(Distribution("uniform"), "norm", loc=1)
    QuantileTransform(Distribution("uniform"), "norm", loc=1)
    """

    def __init__(self, node, distr, *args, **kwargs):
        if not isinstance(node, Node):
            raise TypeError(f"QuantileTransform needs a graph node, got {node!r}.")
        self.node = node
        self.distr = str(distr)
        self.args = args
        self.kwargs = kwargs
        super().__init__()

    def __repr__(self):
        if Transform._repr_capped():
            return f'{type(self).__name__}(..., "{self.distr}")'
        with Transform._repr_frame():
            parts = [repr(self.node), f'"{self.distr}"']
            parts += [repr(a) for a in self.args]
            parts += [f"{k}={v!r}" for k, v in self.kwargs.items()]
        return f"{type(self).__name__}({', '.join(parts)})"

    def get_parents(self):
        yield self.node
        for arg in self.args + tuple(self.kwargs.values()):
            if isinstance(arg, Node):
                yield arg

    def _rewire(self, update):
        self.node = update(self.node)
        self.args = tuple(update(a) for a in self.args)
        self.kwargs = {k: update(v) for k, v in self.kwargs.items()}

    def _static_signature(self):
        sig_args = tuple("<node>" if isinstance(a, Node) else repr(a) for a in self.args)
        sig_kwargs = tuple(
            (k, "<node>" if isinstance(v, Node) else repr(v))
            for k, v in sorted(self.kwargs.items())
        )
        return ("QuantileTransform", self.distr, sig_args, sig_kwargs)

    def _emit(self, ctx):
        from probabilit_tpu_torch.ops.qmc import clamp_open_unit_wide

        def unpack(arg):
            return ctx.value(arg) if isinstance(arg, Node) else arg

        u = clamp_open_unit_wide(torch.as_tensor(ctx.value(self.node)).to(config.float_dtype()))
        args = tuple(unpack(a) for a in self.args)
        kwargs = {k: unpack(v) for k, v in self.kwargs.items()}
        return ppf.call_wide(self.distr, u, *args, **kwargs)


def MultivariateDistribution(distr, *args, **kwargs):
    """The marginal slices of a multivariate distribution, one per event
    dimension.

    >>> d1, d2 = MultivariateDistribution("dirichlet", alpha=[1, 2])
    >>> d1
    MarginalDistribution(Distribution("dirichlet", alpha=[1, 2]), d=0)
    """
    node = Distribution(distr, *args, **kwargs)
    d = node._mv_dim()
    yield from (MarginalDistribution(node, d=i) for i in range(d))
