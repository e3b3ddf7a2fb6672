"""Carry a model built with the JAX package over to the port.

The "weights" of this system are its graph and its quantile matrix.  The
matrix crosses as a numpy array; the graph crosses through
``from_reference``, which reads a ``probabilit_tpu`` graph by duck typing
(``type(node).__name__``, ``_id``, ``get_parents()``, ``.distr``,
``.args``, ``.kwargs``, ``.value``, and the table nodes' arrays) and never
imports that package.
"""

from __future__ import annotations

import numpy as np

from probabilit_tpu_torch.models import graph as _graph
from probabilit_tpu_torch.models.distributions import (
    CopulaDistribution,
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EllipticalCopulaDistribution,
    EmpiricalCopulaDistribution,
    EmpiricalDistribution,
    MarginalDistribution,
    QuantileTransform,
)

__all__ = ["from_reference"]


def _is_node(x):
    return hasattr(x, "_id") and hasattr(x, "get_parents")


def from_reference(sink):
    """Build the port's equivalent of the graph above ``sink``.

    Returns ``{reference node _id: port node}``.  Port nodes are created
    in increasing reference ``_id`` order (parents are always older than
    their children), so both graphs break topological ties alike and
    assign the same quantile columns.  Declared correlations are carried
    over as they are.  A subclass of the reference's ``Distribution`` (the
    ``Lognormal`` factory) becomes a ``Distribution`` of its family; the
    table nodes carry their arrays over as numpy; the copula nodes their
    family and parameters (an empirical copula its pseudo-observations,
    whose own ranks reproduce them); a ``MarginalDistribution`` its slice,
    a ``QuantileTransform`` its family and parameters, and a
    ``ScalarFunctionTransform`` the same Python function and static
    arguments, its node arguments mapped.
    """
    seen = {sink._id: sink}
    stack = [sink]
    while stack:
        for parent in stack.pop().get_parents():
            if parent._id not in seen:
                seen[parent._id] = parent
                stack.append(parent)

    mapping = {}

    def convert(x):
        return mapping[x._id] if _is_node(x) else x

    for ref in sorted(seen.values(), key=lambda node: node._id):
        name = type(ref).__name__
        cls = getattr(_graph, name, None)
        if name == "Constant":
            node = _graph.Constant(ref.value)
        elif "Distribution" in {c.__name__ for c in type(ref).__mro__}:
            node = Distribution(
                ref.distr,
                *(convert(a) for a in ref.args),
                **{k: convert(v) for k, v in ref.kwargs.items()},
            )
        elif name == "EmpiricalDistribution":
            node = EmpiricalDistribution(np.array(ref.data), **ref.kwargs)
        elif name == "CumulativeDistribution":
            node = CumulativeDistribution(np.array(ref.q), np.array(ref.cumulatives))
        elif name == "DiscreteDistribution":
            node = DiscreteDistribution(np.array(ref.values), np.array(ref.probabilities))
        elif name == "CopulaDistribution":
            node = CopulaDistribution(ref.family, ref.theta, ref.d)
        elif name == "EllipticalCopulaDistribution":
            node = EllipticalCopulaDistribution(ref.family, np.array(ref.corr), ref.df)
        elif name == "EmpiricalCopulaDistribution":
            node = EmpiricalCopulaDistribution(np.array(ref.pseudo))
        elif name == "MarginalDistribution":
            node = MarginalDistribution(mapping[ref.distr._id], ref.d)
        elif name == "QuantileTransform":
            node = QuantileTransform(
                mapping[ref.node._id],
                ref.distr,
                *(convert(a) for a in ref.args),
                **{k: convert(v) for k, v in ref.kwargs.items()},
            )
        elif name == "ScalarFunctionTransform":
            node = _graph.ScalarFunctionTransform(
                ref.func,
                tuple(convert(a) for a in ref.args),
                {k: convert(v) for k, v in ref.kwargs.items()},
                dtype=ref.dtype,
            )
        elif isinstance(cls, type) and issubclass(cls, _graph.Transform):
            node = cls(*(mapping[p._id] for p in ref.get_parents()))
        else:
            raise NotImplementedError(f"{name} has no counterpart in the port yet.")
        mapping[ref._id] = node

    for ref in seen.values():
        for variables, corr_mat in getattr(ref, "_correlations", []):
            mapping[ref._id]._correlations.append(
                ([mapping[v._id] for v in variables], np.array(corr_mat))
            )
    return mapping
