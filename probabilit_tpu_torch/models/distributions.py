"""Distribution node types for the modeling language.

Port of ``probabilit_tpu/models/distributions.py:41-138``: the abstract
sampling node and the parametric ``Distribution``, whose samples are the
inverse CDF (``ops/ppf.py``) of its quantile column.  Empirical,
Cumulative, Discrete, Multivariate and copula distributions are still to
port (ROADMAP A8).
"""

from __future__ import annotations

import abc

from probabilit_tpu_torch.models.graph import Node, OverloadMixin, Transform
from probabilit_tpu_torch.ops import ppf

__all__ = ["AbstractDistribution", "Distribution"]


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

    def _emit(self, ctx):
        q = ctx.column(self)

        def unpack(arg):
            return ctx.value(arg) if isinstance(arg, Node) else arg

        args = tuple(unpack(a) for a in self.args)
        kwargs = {k: unpack(v) for k, v in self.kwargs.items()}
        return ppf.call(self.distr, q, *args, **kwargs)
