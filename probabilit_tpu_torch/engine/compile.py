"""Graph planning and the plain PyTorch executor.

Port of ``probabilit_tpu/engine/compile.py:47-291, 383-543``.  The JAX
package stages the graph into one jitted XLA program; PyTorch runs
eagerly, so here ``build_body`` returns a function that evaluates the
graph op by op on a ``(n, d)`` quantile matrix, in the same three phases:

1. initial sampling nodes (ISNs) and their parameter ancestors;
2. correlation induction (not ported yet: raises ``NotImplementedError``);
3. every node in topological order, keeping only the requested outputs.

There is no program cache: nothing is traced or compiled.
"""

from __future__ import annotations

from probabilit_tpu_torch.models import graph as _graph

__all__ = ["EmitContext", "Plan", "get_plan", "build_body"]


class EmitContext:
    """Evaluation context handed to ``Node._emit``: memoised lazy values."""

    def __init__(self, n, columns, device):
        self.n = n
        self.device = device
        self._columns = columns  # node_id -> (n,) quantile column
        self._values = {}

    def value(self, node):
        nid = node._id
        if nid not in self._values:
            self._values[nid] = node._emit(self)
        return self._values[nid]

    def column(self, node):
        return self._columns[node._id]


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
        # Multi-column (path) nodes are not ported, so every node owns
        # exactly one column.
        self.d_total = self.d

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

    def _analyze_correlations(self):
        """Collect and validate declared correlations.

        Only the validation is ported: the correlated variables must be
        ISNs, each pair declared once.  The nearest-correlation repair and
        the correlators come with the next slice (ROADMAP A6).
        """
        correlations = []
        for node in self.topo:
            correlations.extend(node._correlations)

        isn_set = set(self.isns)
        for variables, _ in correlations:
            for variable in variables:
                if variable not in isn_set:
                    raise ValueError(f"Cannot correlate variable: {variable}")

        variable_sets = [set(variables) for (variables, _) in correlations]
        for i, vars1 in enumerate(variable_sets):
            for vars2 in variable_sets[i + 1 :]:
                common = vars1.intersection(vars2)
                if len(common) > 1:
                    raise ValueError(f"Correlations specified more than once: {common}")

        self.correlations = correlations
        self.corr_vars = sorted(set().union(*variable_sets), key=lambda n: n._id)


def get_plan(sink):
    """Build (or fetch) the Plan for ``sink``, cached on the node itself.

    The cache entry is dropped when ``Node._mutation_epoch`` moves and by
    ``Node.copy`` (the copy shares ``_id`` s with the original).
    """
    cached = getattr(sink, "_plan_cache", None)
    if cached is not None:
        epoch, plan = cached
        if epoch == _graph.Node._mutation_epoch:
            return plan
    plan = Plan(sink)
    sink._plan_cache = (_graph.Node._mutation_epoch, plan)
    return plan


def build_body(plan, keep_ids):
    """The 3-phase sampling function for ``plan``.

    Returns ``body(quantiles) -> {node_id: tensor}`` for the kept nodes;
    ``quantiles`` is an ``(n, d)`` tensor, already clamped to (0, 1).
    """
    topo = list(plan.topo)
    pre_topo = list(plan.pre_topo)
    col_of = dict(plan.col_of)
    keep_ids = frozenset(keep_ids)
    correlated = bool(plan.corr_vars)
    parents_of = {node._id: {p._id for p in node.get_parents()} for node in topo}
    n_children = {node._id: 0 for node in topo}
    for pids in parents_of.values():
        for pid in pids:
            n_children[pid] += 1

    def body(quantiles):
        n = quantiles.shape[0]
        columns = {nid: quantiles[:, col] for nid, col in col_of.items()}
        ctx = EmitContext(n=n, columns=columns, device=quantiles.device)

        # Phase 1: initial sampling nodes and their Constant/Transform
        # parameter ancestors, in topological order (bounded recursion).
        for node in pre_topo:
            ctx.value(node)

        # Phase 2: correlation induction.
        if correlated:
            raise NotImplementedError(
                "Correlated graphs are not ported yet: correlation induction "
                "(nearest-correlation repair, Iman-Conover) is the next "
                "slice of the port (ROADMAP A6)."
            )

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
