"""Graph planning and the plain PyTorch executor.

Port of ``probabilit_tpu/engine/compile.py:35-543``.  The JAX package
stages the graph into one jitted XLA program; PyTorch runs eagerly, so
here ``build_body`` returns a function that evaluates the graph op by op
on a ``(n, d)`` quantile matrix, in the same three phases:

1. initial sampling nodes (ISNs) and their parameter ancestors;
2. correlation induction on the declared variables, after a
   nearest-correlation repair of the target (``Plan``);
3. every node in topological order, keeping only the requested outputs.

A path node (``models/processes.py``) owns a slab of ``_q_width``
columns of an explicit quantile matrix (``Plan.slab_of``, ``d_total``)
and one column of the uniforms the engine draws (``EmitContext.drawn``).

Phase 2 has two branches, as in the JAX package: the sort-free
Gaussian-copula recolouring when the engine generated the uniforms
itself (``sample(method=None)``), and the correlator's own transform
(Iman-Conover's four sorts) on an explicit quantile matrix.  A
mixed-score correlator (``StudentTCopula``) draws its mixing scales from
a generator keyed by the first correlated column's leading quantiles, in
both branches.  There is no program cache: nothing is traced or compiled.

Under a device mesh (``parallel/mesh.py``) ``map_quantiles`` runs a body
on each shard's rows when the plan needs no other shard's rows
(``shards_alone``), and on the gathered rows on ``mesh.devices[0]``
otherwise, where phase 2 takes Iman-Conover's column-sharded transform.
"""

from __future__ import annotations

import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.models import graph as _graph
from probabilit_tpu_torch.ops import correlation as _correlation
from probabilit_tpu_torch.ops import ncm as _ncm
from probabilit_tpu_torch.ops import ppf as _ppf
from probabilit_tpu_torch.ops import special as _special
from probabilit_tpu_torch.ops.qmc import clamp_open_unit
from probabilit_tpu_torch.parallel import mesh as _mesh
from probabilit_tpu_torch.utils import build_corrmat
from probabilit_tpu_torch.utils import profiling as _profiling

__all__ = [
    "CORRELATOR_MAP",
    "EmitContext",
    "Plan",
    "get_plan",
    "resolve_correlator",
    "correlator_token",
    "instantiate_correlator",
    "recolor_eligible",
    "check_rows",
    "build_body",
]

CORRELATOR_MAP = {
    "imanconover": _correlation.ImanConover,
    "cholesky": _correlation.Cholesky,
    # The t copula at its default df; a parameterised one is passed as an
    # instance, e.g. sample(correlator=StudentTCopula(df=3)).
    "tcopula": _correlation.StudentTCopula,
}
# The salt of a mixed-score correlator's stream (``_mixing_key``).
_MIX_SALT = 0x7C09

_NCM_CACHE = {}


class EmitContext:
    """Evaluation context handed to ``Node._emit``: memoised lazy values.

    ``drawn`` says where the uniforms came from: True when the engine drew
    them itself (``method=None``), False for an explicit quantile matrix
    (a ``method=`` sequence, ``sample_from_quantiles``).  The JAX package
    reads the same fact off its in-trace PRNG key (``gen_key``).  Path
    nodes branch on it: on an explicit matrix they read their slab of
    columns (``slab``), otherwise they draw from a generator keyed by
    their own column.
    """

    def __init__(self, n, columns, device, quantiles=None, slabs=None, drawn=False):
        self.n = n
        self.device = device
        self._columns = columns  # node_id -> (n,) quantile column
        self._quantiles = quantiles  # the full (n, d_total) matrix
        self._slabs = slabs or {}  # node_id -> (own column, start, extra)
        self.drawn = drawn
        self._values = {}

    def value(self, node):
        nid = node._id
        if nid not in self._values:
            self._values[nid] = node._emit(self)
        return self._values[nid]

    def set_value(self, node, value):
        self._values[node._id] = value

    def column(self, node):
        return self._columns[node._id]

    def slab(self, node):
        """The node's ``(n, _q_width)`` quantile slab (explicit matrix only).

        Dimension 0 is the node's own column (the one that keys its
        generator when the engine draws), so its best-placed QMC dimension
        drives its dominant feature; the other ``_q_width - 1`` columns
        are the node's block past the scalar columns.
        """
        own, start, extra = self._slabs[node._id]
        col = self._quantiles[:, own : own + 1]
        if not extra:
            return col
        return torch.cat([col, self._quantiles[:, start : start + extra]], dim=1)


class Plan:
    """Static analysis of a graph: topo order, column map, correlations."""

    def __init__(self, sink):
        self.sink = sink
        self.topo = _graph.topological_sort(sink)

        has_dist_ancestor = {}
        for node in self.topo:
            has_dist_ancestor[node._id] = any(
                p._is_distribution or has_dist_ancestor[p._id]
                for p in node.get_parents()
            )
        self.isns = sorted(
            (
                n
                for n in self.topo
                if n._is_distribution and not has_dist_ancestor[n._id]
            ),
            key=lambda n: n._id,
        )

        # Column assignment: ISNs sorted by _id first, then composite
        # distribution nodes in topological order (the reference's
        # consumption order, and the JAX package's).
        composite = [
            n for n in self.topo if n._is_distribution and has_dist_ancestor[n._id]
        ]
        self.dist_nodes = self.isns + composite
        self.col_of = {n._id: i for i, n in enumerate(self.dist_nodes)}
        self.d = len(self.dist_nodes)

        # Multi-column nodes (path processes declare ``_q_width``) own a
        # slab of columns on an explicit quantile matrix: their own scalar
        # column is dimension 0, and the other ``_q_width - 1`` drivers
        # follow as one block past the scalar columns.  ``d_total`` is the
        # matrix's width; without a path node it is ``d``.  Uniforms the
        # engine draws itself stay (n, d).
        self.slab_of = {}
        off = self.d
        for node in self.dist_nodes:
            width = getattr(node, "_q_width", None)
            if width is None:
                continue
            extra = max(int(width) - 1, 0)
            self.slab_of[node._id] = (self.col_of[node._id], off, extra)
            off += extra
        self.d_total = off

        # Topo-ordered prefix needed before correlation induction: the ISNs
        # and their (Constant/Transform) ancestors.
        in_prefix = set()
        stack = list(self.isns)
        while stack:
            node = stack.pop()
            if node._id in in_prefix:
                continue
            in_prefix.add(node._id)
            stack.extend(node.get_parents())
        self.pre_topo = [n for n in self.topo if n._id in in_prefix]

        self._analyze_correlations()

        # Host-side output finalizers (the gather of a string-valued
        # DiscreteDistribution's values), by node id.
        self.finalizers = {}
        for node in self.topo:
            fin = getattr(node, "_host_finalizer", None)
            fn = fin() if fin is not None else None
            if fn is not None:
                self.finalizers[node._id] = fn

    def _analyze_correlations(self):
        """Collect and validate declared correlations, and repair the
        target to the nearest correlation matrix (cached by its bytes)."""
        correlations = []
        for node in self.topo:
            correlations.extend(node._correlations)

        isn_set = set(self.isns)
        for variables, _ in correlations:
            for variable in variables:
                if variable not in isn_set:
                    raise ValueError(f"Cannot correlate variable: {variable}")
                if getattr(variable, "_vector_valued", False):
                    # A copula node is (n, d); the correlators stack 1-D
                    # sample vectors.
                    raise ValueError(
                        f"Cannot correlate vector-valued node {variable!r}; "
                        "correlate scalar marginals or functionals of it instead."
                    )

        variable_sets = [set(variables) for (variables, _) in correlations]
        for i, vars1 in enumerate(variable_sets):
            for vars2 in variable_sets[i + 1 :]:
                common = vars1.intersection(vars2)
                if len(common) > 1:
                    raise ValueError(f"Correlations specified more than once: {common}")

        if not correlations:
            self.corr_vars = []
            self.corr_matrix = None
            return

        self.corr_vars = sorted(set().union(*variable_sets), key=lambda n: n._id)
        var_to_int = {v: i for i, v in enumerate(self.corr_vars)}
        raw = build_corrmat(
            [
                (tuple(var_to_int[var] for var in variables), corrmat)
                for (variables, corrmat) in correlations
            ]
        )
        cache_key = raw.tobytes()
        cached = _NCM_CACHE.get(cache_key)
        if cached is None:
            cached = _ncm.nearest_correlation_matrix(raw)
            if len(_NCM_CACHE) > 64:
                _NCM_CACHE.pop(next(iter(_NCM_CACHE)))
            _NCM_CACHE[cache_key] = cached
        self.corr_matrix = cached

    def columns_of(self, node):
        """Every quantile column the node's randomness consumes: its own,
        and a path node's block of extra drivers."""
        nid = node._id
        cols = [self.col_of[nid]]
        if nid in self.slab_of:
            _, start, extra = self.slab_of[nid]
            cols.extend(range(start, start + extra))
        return tuple(cols)


def get_plan(sink):
    """Build (or fetch) the Plan for ``sink``, cached on the node itself.

    The cache entry is dropped when ``Node._mutation_epoch`` moves and by
    ``Node.copy`` (the copy shares ``_id`` s with the original).  A plan
    built here is the ``probabilit.plan`` span of a ``torch.profiler``
    trace.
    """
    cached = getattr(sink, "_plan_cache", None)
    if cached is not None:
        epoch, plan = cached
        if epoch == _graph.Node._mutation_epoch:
            return plan
    with _profiling.span("probabilit.plan"):
        plan = Plan(sink)
    sink._plan_cache = (_graph.Node._mutation_epoch, plan)
    return plan


def resolve_correlator(correlator):
    """Name -> class from ``CORRELATOR_MAP``; classes and instances pass
    through (an instance carries its configuration, e.g. ``ties``)."""
    if isinstance(correlator, str):
        return CORRELATOR_MAP[correlator.lower()]
    return correlator


def _mixing_key(instance, column):
    """The mixing stream of a mixed-score correlator: a ``torch.Generator``
    keyed by the float32 bits of the first correlated column's leading
    quantiles and the correlator's ``seed`` (``multivariate._key_from_q``),
    so a streamed block's mixing follows its own quantiles.  None for a
    Gaussian-score correlator."""
    if getattr(type(instance), "gaussian_scores", True):
        return None
    from probabilit_tpu_torch.ops import multivariate as _mv

    return _mv._key_from_q(column, salt=(_MIX_SALT, getattr(instance, "seed", 0)))


def correlator_token(correlator_cls):
    """Hashable identity of a resolved correlator (class or instance)."""
    if isinstance(correlator_cls, _correlation.Correlator):
        return correlator_cls._cache_token()
    return getattr(correlator_cls, "__qualname__", str(correlator_cls))


def instantiate_correlator(correlator_cls):
    """A usable instance from a resolved correlator (class or instance)."""
    if isinstance(correlator_cls, _correlation.Correlator):
        return correlator_cls
    return correlator_cls()


def _active_mesh_key():
    """The active mesh's cache identity (axis names, shard count, first
    device), or None: a program built without a mesh is never reused
    under one."""
    m = _mesh.current_mesh()
    return None if m is None else (m.axis_names, m.size, str(m.devices[0]))


def find_key_seeded(plan):
    """The first node whose randomness comes from a generator keyed by its
    quantile column (a copula node, or a multivariate ``Distribution``),
    or None."""
    from probabilit_tpu_torch.models.distributions import Distribution, _scipy_is_multivariate

    for node in plan.topo:
        if getattr(node, "_key_seeded", False):
            return node
        if isinstance(node, Distribution) and _scipy_is_multivariate(node.distr):
            return node
    return None


def shards_alone(plan, drawn):
    """Can each shard evaluate the plan on its own rows?  Not with
    declared correlations (statistics and ranks over every row), nor with
    a node keyed by its column's leading quantiles, which only shard 0
    holds: a key-seeded node, or a path node on drawn uniforms."""
    if plan.corr_matrix is not None or find_key_seeded(plan) is not None:
        return False
    return not (drawn and plan.slab_of)


def map_quantiles(plan, fn, quantiles, drawn=False, axis=0):
    """``fn(quantiles)`` under the active mesh.

    Without a mesh, one call.  Under one, ``quantiles`` (a tensor, or
    its row blocks as ``mesh.split_rows`` gives them) is split by rows and
    ``fn`` runs on each shard's block on its device when ``shards_alone``
    allows, the outputs gathered on ``mesh.devices[0]`` along ``axis`` (the
    output's sample axis); otherwise ``fn`` runs once there on the
    gathered rows."""
    mesh = _mesh.current_mesh()
    if mesh is None:
        return fn(quantiles)
    if shards_alone(plan, drawn):
        return _mesh.map_rows(fn, quantiles, mesh, axis)
    if isinstance(quantiles, (tuple, list)):
        quantiles = _mesh.gather_rows(quantiles, [b.shape[0] for b in quantiles],
                                      mesh.devices[0])
    return fn(quantiles.to(mesh.devices[0]))


def _generatable(var):
    """Is this variable's sampler a monotone scalar inverse CDF?

    True for a univariate ``Distribution`` (scipy says which are), an
    ``EmpiricalDistribution``, a ``CumulativeDistribution`` and a numeric
    ``DiscreteDistribution``: sorted uniforms map to sorted samples.
    """
    import numpy as np

    from probabilit_tpu_torch.models.distributions import (
        CumulativeDistribution,
        DiscreteDistribution,
        Distribution,
        EmpiricalDistribution,
        _scipy_is_multivariate,
    )

    if isinstance(var, Distribution):
        try:
            return not _scipy_is_multivariate(var.distr)
        except AttributeError:
            return False
    if isinstance(var, (EmpiricalDistribution, CumulativeDistribution)):
        return True
    if isinstance(var, DiscreteDistribution):
        return np.issubdtype(var.values.dtype, np.number)
    return False


def recolor_eligible(plan, correlator_cls):
    """Can generated sampling induce this plan's correlations sort-free?

    True when the plan declares correlations, the correlator has
    ``_recolor_scores`` (Gaussian-copula score recolouring), and every
    correlated variable is ``_generatable``.
    """
    return (
        plan.corr_matrix is not None
        and hasattr(correlator_cls, "_recolor_scores")
        and all(_generatable(v) for v in plan.corr_vars)
    )


def check_rows(plan, n):
    """The ``n <= K`` guard of a correlated plan."""
    if plan.corr_matrix is not None and n <= len(plan.corr_vars):
        raise ValueError(
            "Inducing correlations needs more observations than "
            "variables (rows > columns); X has shape "
            f"({n}, {len(plan.corr_vars)})."
        )


def build_body(plan, keep_ids, correlator="imanconover", generated=False, drawn=False):
    """The 3-phase sampling function for ``plan``.

    Returns ``body(quantiles) -> {node_id: tensor}`` for the kept nodes;
    ``quantiles`` is an ``(n, d)`` tensor (``(n, d_total)`` when it is an
    explicit matrix), already clamped to (0, 1).  ``drawn=True`` says the
    engine drew the uniforms (``EmitContext.drawn``).  ``generated=True``
    (the engine drew them, and ``recolor_eligible`` holds) takes the
    sort-free recolouring branch of phase 2; otherwise the correlator
    transforms the sampled columns.
    """
    corr_matrix = plan.corr_matrix
    correlator_cls = None if corr_matrix is None else resolve_correlator(correlator)
    corr_vars = list(plan.corr_vars)
    corr_var_ids = frozenset(v._id for v in corr_vars)
    topo = list(plan.topo)
    pre_topo = list(plan.pre_topo)
    col_of = dict(plan.col_of)
    slab_of = dict(plan.slab_of)
    drawn = drawn or generated
    keep_ids = frozenset(keep_ids)
    parents_of = {node._id: {p._id for p in node.get_parents()} for node in topo}
    n_children = {node._id: 0 for node in topo}
    for pids in parents_of.values():
        for pid in pids:
            n_children[pid] += 1

    def body(quantiles):
        n = quantiles.shape[0]
        check_rows(plan, n)
        columns = {nid: quantiles[:, col] for nid, col in col_of.items()}
        ctx = EmitContext(
            n=n, columns=columns, device=quantiles.device, quantiles=quantiles,
            slabs=slab_of, drawn=drawn,
        )
        fast = generated and corr_matrix is not None

        # Phase 1: initial sampling nodes and their Constant/Transform
        # parameter ancestors, in topological order (bounded recursion).
        for node in pre_topo:
            if fast and node._id in corr_var_ids:
                continue  # Produced by the recolouring below.
            ctx.value(node)

        # Phase 2: correlation induction on the declared variables,
        # stacked on the leading axis (K, n).
        if corr_matrix is not None:
            instance = instantiate_correlator(correlator_cls).set_target(corr_matrix)
            dtype = config.float_dtype()
            w_key = _mixing_key(instance, ctx.column(corr_vars[0]))
            if fast:
                # Sort-free Gaussian-copula Iman-Conover: recolour the
                # normal scores of the variables' own uniforms to the
                # target correlation, then push each score row through
                # the closed-form score ppf (norm, lognorm) or through
                # ndtr into the variable's own inverse CDF.
                z = torch.stack(
                    [_special.ndtri_fast(ctx.column(v).to(dtype)) for v in corr_vars]
                )
                y = instance._recolor_scores(z)
                gaussian = w_key is None
                if not gaussian:
                    # Mixed scores: one shared mixing draw, the rows to
                    # uniforms one at a time; score_emit's closed forms
                    # assume Gaussian scores and are skipped.
                    u_rows = clamp_open_unit(instance._copula_uniforms(y, w_key))
                for i, var in enumerate(corr_vars):
                    val_i = _ppf.score_emit(var, y[i], ctx) if gaussian else None
                    if val_i is None:
                        saved = ctx._columns[var._id]
                        ctx._columns[var._id] = (
                            clamp_open_unit(_special.ndtr_fast(y[i])) if gaussian else u_rows[i]
                        )
                        val_i = var._emit(ctx)
                        ctx._columns[var._id] = saved
                    ctx.set_value(var, val_i)
            else:
                XT = torch.stack([ctx.value(v) for v in corr_vars]).to(dtype)
                if hasattr(instance, "_apply_rows"):
                    X_corr_T = instance._apply_rows(XT, w_key=w_key)
                else:
                    X_corr_T = instance._apply(XT.T).T
                for i, var in enumerate(corr_vars):
                    ctx.set_value(var, X_corr_T[i])

        # Phase 3: propagate in topological order and keep only the
        # requested outputs.  Eager PyTorch has no dead-code elimination,
        # so a value that is not kept is released after its last child.
        outputs = {}
        remaining = dict(n_children)
        for node in topo:
            value = ctx.value(node)
            if node._id in keep_ids:
                outputs[node._id] = value
            for pid in parents_of[node._id]:
                remaining[pid] -= 1
                if remaining[pid] == 0 and pid not in keep_ids:
                    del ctx._values[pid]
        return outputs

    return body
