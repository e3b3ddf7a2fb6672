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
from probabilit_tpu_torch.models import levy, markov, processes, sde, stochvol
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

# Path nodes: each class, and its constructor's arguments, read off the
# reference node's attributes of the same names.
_PATH_NODES = {
    cls.__name__: (cls, args)
    for cls, args in (
        (processes.BrownianPath, ("x0", "drift", "diffusion", "T", "steps")),
        (processes.GBMPath, ("s0", "mu", "sigma", "T", "steps")),
        (processes.OUPath, ("x0", "theta", "mu", "sigma", "T", "steps")),
        (processes.PoissonProcessPath, ("rate", "T", "steps")),
        (processes.MertonJumpPath,
         ("s0", "mu", "sigma", "jump_rate", "jump_mean", "jump_std", "T", "steps")),
        (processes.CorrelatedGBMPaths, ("s0", "mu", "sigma", "corr", "T", "steps")),
        (processes.CorrelatedMertonPaths,
         ("s0", "mu", "sigma", "corr", "jump_rate", "jump_mean", "jump_std", "common_rate",
          "common_mean", "common_std", "loadings", "T", "steps")),
        (levy.VGPath, ("mu", "theta", "sigma", "nu", "T", "steps")),
        (levy.NIGPath, ("alpha", "beta", "delta", "mu", "T", "steps")),
        (stochvol.CIRPath, ("v0", "kappa", "theta", "sigma", "T", "steps")),
        (stochvol.HestonPath, ("s0", "mu", "v0", "kappa", "theta", "sigma", "rho", "T", "steps")),
        (stochvol.CorrelatedHestonPaths,
         ("s0", "mu", "v0", "kappa", "theta", "sigma", "rho", "corr", "T", "steps", "var_corr")),
        (sde.SDEPath, ("drift", "diffusion", "x0", "T", "steps", "scheme")),
        (markov.MarkovChainPath, ("transition", "x0", "values", "T", "steps")),
        (markov.RegimeSwitchingGBMPath,
         ("s0", "mu", "sigma", "transition", "x0_state", "T", "steps")),
    )
}


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
    a ``QuantileTransform`` its family and parameters, a
    ``ScalarFunctionTransform`` the same Python function and static
    arguments, its node arguments mapped, and a path node its parameters
    (an ``SDEPath`` the same callables, which then run on torch tensors; a
    callable that calls ``jnp`` fails with its own error), an
    ``AssetPath`` view and a ``PathFunctional`` theirs over the mapped
    joint or path node.
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
        elif name in _PATH_NODES:
            cls, args = _PATH_NODES[name]
            values = (getattr(ref, k) for k in args)
            node = cls(**{k: np.array(v) if isinstance(v, np.ndarray) else v
                          for k, v in zip(args, values)})
        elif name == "AssetPath":
            node = processes.AssetPath(mapping[ref.joint._id], ref.asset)
        elif name == "PathFunctional":
            node = mapping[ref.path._id]._functional(ref.op, ref.index)  # into the memo
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
