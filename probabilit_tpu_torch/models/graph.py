"""The computational-graph modeling language, evaluated with PyTorch.

Port of ``probabilit_tpu/models/graph.py:104-820``: lazy ``Node`` graphs
built by operator overloading, hashed by a unique monotonic id, sampled by
calling ``.sample(n)`` on any node.  Each node carries its graph structure
(``get_parents``) and ``_emit(ctx)``, which computes the node's samples
from its parents' tensors with the same numeric semantics as the JAX
package (``jnp`` type promotion: integer constants stay integers,
comparisons give booleans).

``ScalarFunctionTransform`` (``scalar_transform``) runs an arbitrary scalar
Python function: ``torch.vmap`` where the function traces, else the
per-sample host loop the JAX package falls back to (``pure_callback``),
with its warning.
"""

from __future__ import annotations

import abc
import contextlib
import copy as _copy
import functools
import heapq
import itertools
import numbers
import operator
import warnings

import numpy as np
import torch

from probabilit_tpu_torch import config

__all__ = [
    "Node",
    "OverloadMixin",
    "Constant",
    "Transform",
    "VariadicTransform",
    "BinaryTransform",
    "UnaryTransform",
    "ScalarFunctionTransform",
    "scalar_transform",
    "python_to_prob",
    "topological_sort",
    # variadic
    "Add",
    "Multiply",
    "Max",
    "Min",
    "All",
    "Any",
    "Avg",
    "NoOp",
    # binary
    "FloorDivide",
    "Mod",
    "Divide",
    "Power",
    "Subtract",
    "Equal",
    "NotEqual",
    "LessThan",
    "LessThanOrEqual",
    "GreaterThan",
    "GreaterThanOrEqual",
    "IsClose",
    "Arctan2",
    # unary
    "Negate",
    "Abs",
    "Log",
    "Exp",
    "Floor",
    "Ceil",
    "Sign",
    "Sqrt",
    "Square",
    "Log10",
    "Sin",
    "Cos",
    "Tan",
    "Arcsin",
    "Arccos",
    "Arctan",
    "Sinh",
    "Cosh",
    "Tanh",
    "Arcsinh",
    "Arccosh",
    "Arctanh",
    "Log1p",
    "Expm1",
]


def python_to_prob(argument):
    """Convert basic Python types to probabilit node types."""
    if isinstance(argument, numbers.Number):
        return Constant(argument)
    elif isinstance(argument, Node):
        return argument
    else:
        raise ValueError(f"Type not compatible with probabilit: {argument}")


class Node(abc.ABC):
    """A node in the computational graph.

    Equality and hashing use the unique monotonically-increasing ``_id`` so
    nodes can live in sets; model-level equality must use the ``Equal``
    node.
    """

    id_iter = itertools.count()

    # Bumped by every operation that can change an already-built node's
    # sampling semantics (``correlate``); ``compile.get_plan``
    # keys its per-sink cache on it.
    _mutation_epoch = 0

    # Overridden by AbstractDistribution.
    _is_distribution = False

    def __init__(self):
        self._id = next(Node.id_iter)
        self._correlations = []

    def __eq__(self, other):
        if not isinstance(other, Node):
            return NotImplemented
        return self._id == other._id

    def __hash__(self):
        return self._id

    def get_parents(self):  # pragma: no cover - abstract-ish
        yield from []

    def nodes(self):
        """Yield ``self`` and all ancestors (DFS, duplicates for shared nodes)."""
        queue = [self]
        while queue:
            yield (node := queue.pop())
            queue.extend(node.get_parents())

    def unique_nodes(self):
        """All unique nodes in the upstream graph (self included)."""
        seen = {self._id: self}
        stack = [self]
        while stack:
            node = stack.pop()
            for parent in node.get_parents():
                if parent._id not in seen:
                    seen[parent._id] = parent
                    stack.append(parent)
        return list(seen.values())

    def num_distribution_nodes(self):
        """Number of unique ancestor nodes that are distribution nodes."""
        return sum(1 for node in self.unique_nodes() if node._is_distribution)

    def to_graph(self):
        """The computational graph as a networkx ``MultiDiGraph``.

        Each node contributes its parent edges once; repeated parents of
        one node (``a + a``) give parallel edges.  networkx is imported
        here, at the call: nothing else in the package needs it.
        """
        import networkx as nx

        nodes = self.unique_nodes()
        if len(nodes) == 1:
            G = nx.MultiDiGraph()
            G.add_node(self)
            return G
        edge_list = [
            (ancestor, node)
            for node in nodes
            for ancestor in node.get_parents()
            if not node.is_leaf
        ]
        return nx.MultiDiGraph(edge_list)

    def copy(self):
        """Copy the node and its entire upstream graph, preserving ``_id`` s
        and ``samples_``."""
        id_to_new = {}

        def update(item):
            if isinstance(item, Node):
                return id_to_new[item._id]
            return _copy.deepcopy(item)

        for node in topological_sort(self):
            copied = _copy.copy(node)
            # The shallow copy would share the original's cached plan,
            # whose topo points at the original nodes.
            copied.__dict__.pop("_plan_cache", None)
            id_to_new[copied._id] = copied
            if getattr(copied, "samples_", None) is not None:
                copied.samples_ = copied.samples_.clone()
            copied._correlations = [
                ([id_to_new.get(v._id, v) for v in variables], corrmat.copy())
                for (variables, corrmat) in copied._correlations
            ]
            copied._rewire(update)

        return id_to_new[self._id]

    def _rewire(self, update):
        """Update parent references after a graph copy (subclass hook)."""

    def sample(
        self,
        size=None,
        random_state=None,
        method=None,
        correlator="imanconover",
        gc_strategy=None,
        executor=None,
    ):
        """Sample this node; populates ``.samples_`` on the kept nodes.

        ``executor=None`` runs the plain PyTorch executor on
        ``config.device()``; ``executor="cuda"`` runs the whole graph in one
        hand-written CUDA kernel (``engine/cuda_exec.py``).
        """
        from probabilit_tpu_torch.engine import sampler

        return sampler.sample(
            self,
            size=size,
            random_state=random_state,
            method=method,
            correlator=correlator,
            gc_strategy=gc_strategy,
            executor=executor,
        )

    def sample_from_quantiles(self, quantiles, correlator="imanconover", gc_strategy=None):
        """Push a user-supplied ``(size, d)`` quantile matrix through the graph."""
        from probabilit_tpu_torch.engine import sampler

        return sampler.sample_from_quantiles(
            self, quantiles, correlator=correlator, gc_strategy=gc_strategy
        )

    def sample_streaming(self, size, block_size=16_777_216, random_state=None, **kwargs):
        """Sample in device-sized blocks; see ``engine.streaming``."""
        from probabilit_tpu_torch.engine import streaming

        return streaming.sample_streaming(
            self, size, block_size=block_size, random_state=random_state, **kwargs
        )

    def estimate(self, size, block_size=16_777_216, random_state=None, **kwargs):
        """Streaming mean/var/min/max (plus quantiles, CVaR, histograms,
        ...) at any sample count; O(block) memory.  See
        ``engine.streaming.estimate``."""
        from probabilit_tpu_torch.engine import streaming

        return streaming.estimate(
            self, size, block_size=block_size, random_state=random_state, **kwargs
        )

    def sensitivity(self, wrt, size=65536, random_state=None, **kwargs):
        """Pathwise derivative of a statistic of this node with respect to
        distribution parameters, by ``torch.autograd`` through the plain
        executor.  See ``engine.sensitivity.sensitivity``."""
        from probabilit_tpu_torch.engine import sensitivity as _sens

        return _sens.sensitivity(self, wrt, size=size, random_state=random_state, **kwargs)

    def sweep(self, scenarios, size=65536, random_state=None, **kwargs):
        """Statistics of this node under S parameter scenarios, one
        evaluation of the plain executor per scenario, with common random
        numbers by default.  See ``engine.sweep.sweep``."""
        from probabilit_tpu_torch.engine import sweep as _sweep

        return _sweep.sweep(self, scenarios, size=size, random_state=random_state, **kwargs)

    def sobol_indices(self, wrt=None, size=8192, random_state=None, **kwargs):
        """First-order and total Sobol' indices of this node over its
        (independent) sampling variables, by batched pick-freeze on the
        plain executor.  See ``engine.sensitivity.sobol_indices``."""
        from probabilit_tpu_torch.engine import sensitivity as _sens

        return _sens.sobol_indices(self, wrt, size=size, random_state=random_state, **kwargs)

    def _is_initial_sampling_node(self):
        """A distribution with no distribution ancestors."""
        if not self._is_distribution:
            return False
        ancestors = set(self.unique_nodes()) - {self}
        return not any(node._is_distribution for node in ancestors)

    def correlate(self, *variables, corr_mat):
        """Declare a target correlation among ancestor variables.

        The variables must be initial sampling nodes; that is checked at
        sample time (``compile.Plan``).  Returns ``self``.
        """
        corr_mat = np.asarray(corr_mat)
        assert corr_mat.ndim == 2
        assert corr_mat.shape[0] == corr_mat.shape[1]
        assert corr_mat.shape[0] == len(variables)
        assert len(variables) == len(set(variables))
        nodes = set(self.unique_nodes())
        for var in variables:
            if var not in nodes:
                raise ValueError(f"{var} is not an ancestor of {self}")
        self._correlations.append((list(variables), np.copy(corr_mat)))
        Node._mutation_epoch += 1
        return self


def topological_sort(sink):
    """Deterministic topological order of ``sink``'s upstream graph.

    Parents come before children; ties are broken by node ``_id``.
    """
    nodes = {node._id: node for node in sink.unique_nodes()}

    children = {nid: [] for nid in nodes}
    indegree = {nid: 0 for nid in nodes}
    for node in nodes.values():
        parent_ids = {p._id for p in node.get_parents()}
        indegree[node._id] = len(parent_ids)
        for pid in parent_ids:
            children[pid].append(node._id)

    heap = [nid for nid, deg in indegree.items() if deg == 0]
    heapq.heapify(heap)
    order = []
    while heap:
        nid = heapq.heappop(heap)
        order.append(nodes[nid])
        for cid in children[nid]:
            indegree[cid] -= 1
            if indegree[cid] == 0:
                heapq.heappush(heap, cid)
    if len(order) != len(nodes):
        raise ValueError("Graph contains a cycle; sampling requires a DAG.")
    return order


class OverloadMixin:
    """Dunder overloads building Transform nodes.

    ``==`` and ``!=`` are deliberately NOT overloaded (hashing needs them);
    use the ``Equal`` / ``NotEqual`` nodes in models.
    """

    def __add__(self, other):
        return Add(self, other)

    def __radd__(self, other):
        return Add(self, other)

    def __mul__(self, other):
        return Multiply(self, other)

    def __rmul__(self, other):
        return Multiply(self, other)

    def __floordiv__(self, other):
        return FloorDivide(self, other)

    def __rfloordiv__(self, other):
        return FloorDivide(other, self)

    def __truediv__(self, other):
        return Divide(self, other)

    def __rtruediv__(self, other):
        return Divide(other, self)

    def __mod__(self, other):
        return Mod(self, other)

    def __rmod__(self, other):
        return Mod(other, self)

    def __sub__(self, other):
        return Subtract(self, other)

    def __rsub__(self, other):
        return Subtract(other, self)

    def __pow__(self, other):
        return Power(self, other)

    def __rpow__(self, other):
        return Power(other, self)

    def __neg__(self):
        return Negate(self)

    def __abs__(self):
        return Abs(self)

    def __lt__(self, other):
        return LessThan(self, other)

    def __le__(self, other):
        return LessThanOrEqual(self, other)

    def __gt__(self, other):
        return GreaterThan(self, other)

    def __ge__(self, other):
        return GreaterThanOrEqual(self, other)


class Constant(Node, OverloadMixin):
    """A constant number, broadcast over the sample axis.

    Keeps its Python type the way the JAX package does: booleans become
    bool tensors, integers ``config.int_dtype()``, floats
    ``config.float_dtype()``.
    """

    is_leaf = True

    def __init__(self, value):
        self.value = value.value if isinstance(value, Constant) else value
        super().__init__()

    def get_parents(self):
        yield from []

    def __repr__(self):
        return f"{type(self).__name__}({self.value})"

    def _static_signature(self):
        return ("Constant", repr(self.value), type(self.value).__name__)

    def _emit(self, ctx):
        if isinstance(self.value, bool):
            dtype = torch.bool
        elif isinstance(self.value, numbers.Integral):
            dtype = config.int_dtype()
        else:
            dtype = config.float_dtype()
        return torch.full((ctx.n,), self.value, dtype=dtype, device=ctx.device)


# =====================================================================
# Elementwise ops with jax.numpy semantics
# =====================================================================


def _as_float(x):
    """Integer and bool inputs of float-valued functions become floats: an
    integer the configured float dtype, a bool float32 in either mode, as
    jnp computes a float function of a bool in float32 under x64 too."""
    if x.is_floating_point():
        return x
    return x.to(torch.float32 if x.dtype == torch.bool else config.float_dtype())


def _promote(a, b):
    dtype = torch.result_type(a, b)
    return a.to(dtype), b.to(dtype)


def _true_divide(a, b):
    if not (a.is_floating_point() or b.is_floating_point()):
        a, b = _as_float(a), _as_float(b)
    return torch.true_divide(a, b)


def _subtract(a, b):
    # torch refuses `-` on a bool tensor; jnp promotes it to the other type.
    if a.dtype == torch.bool and b.dtype != torch.bool:
        a = a.to(b.dtype)
    elif b.dtype == torch.bool and a.dtype != torch.bool:
        b = b.to(a.dtype)
    return a - b


def _isclose(a, b):
    # jnp.isclose compares integers and bools as floats, within the same
    # tolerances (2^24 + 1 is close to 2^24).
    a, b = _promote(_as_float(a), _as_float(b))
    return torch.isclose(a, b, rtol=1e-5, atol=1e-8)


def _arctan2(a, b):
    a, b = _promote(_as_float(a), _as_float(b))
    return torch.atan2(a, b)


def _sign(x):
    # torch.sign maps NaN to 0; jnp.sign keeps it.
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _float_op(fn):
    """A float-valued elementwise function (ints and bools promote first)."""
    return lambda x: fn(_as_float(x))


def _bool_as_int(x):
    # jnp computes //, %, ** and the square of bools in int32, under x64
    # too; torch refuses them or widens to int64.
    return x.to(torch.int32) if x.dtype == torch.bool else x


def _integer_division(fn, by_zero):
    """``fn`` (``torch.floor_divide`` or ``torch.remainder``) with jnp's
    integer semantics: bools compute as integers, and a zero divisor gives
    ``by_zero(dividend)``, XLA's value, where torch raises on the CPU.
    Float operands go to ``fn`` as they are."""

    def op(a, b):
        if a.is_floating_point() or b.is_floating_point():
            return fn(a, b)
        a, b = _promote(_bool_as_int(a), _bool_as_int(b))
        zero = b == 0
        return torch.where(zero, by_zero(a), fn(a, torch.where(zero, torch.ones_like(b), b)))

    return op


def _power(a, b):
    if a.dtype == torch.bool and b.dtype == torch.bool:
        a, b = _bool_as_int(a), _bool_as_int(b)
    return torch.pow(a, b)


def _bool_is_fixed(fn):
    """abs, floor and ceil leave a bool as it is (jnp); torch refuses it."""
    return lambda x: x if x.dtype == torch.bool else fn(x)


# =====================================================================
# Transforms
# =====================================================================


class Transform(Node, OverloadMixin, abc.ABC):
    """Arithmetic/functional operations on parent samples."""

    is_leaf = False

    # Recursive repr depth cap: deep chains would otherwise exhaust the
    # Python stack whenever anything stringifies a node.
    _REPR_MAX_DEPTH = 50
    _repr_depth = 0

    @classmethod
    def _repr_capped(cls):
        return Transform._repr_depth >= Transform._REPR_MAX_DEPTH

    @classmethod
    @contextlib.contextmanager
    def _repr_frame(cls):
        Transform._repr_depth += 1
        try:
            yield
        finally:
            Transform._repr_depth -= 1

    def __repr__(self):
        if Transform._repr_capped():
            return f"{type(self).__name__}(...)"
        with Transform._repr_frame():
            parents = ", ".join(repr(parent) for parent in self.get_parents())
        return f"{type(self).__name__}({parents})"

    def _static_signature(self):
        return (type(self).__name__,)


class VariadicTransform(Transform):
    """Associative n-ary transforms: ``Add(a, b, c, ...)`` etc."""

    def __init__(self, *args):
        self.parents = tuple(python_to_prob(arg) for arg in args)
        super().__init__()

    def get_parents(self):
        yield from self.parents

    def _rewire(self, update):
        self.parents = tuple(update(p) for p in self.parents)

    def _emit(self, ctx):
        values = [ctx.value(p) for p in self.parents]
        return functools.reduce(type(self).op, values)


class Add(VariadicTransform):
    op = staticmethod(operator.add)


class Multiply(VariadicTransform):
    op = staticmethod(operator.mul)


class Max(VariadicTransform):
    op = staticmethod(torch.maximum)


class Min(VariadicTransform):
    op = staticmethod(torch.minimum)


class All(VariadicTransform):
    op = staticmethod(torch.logical_and)


class Any(VariadicTransform):
    op = staticmethod(torch.logical_or)


class Avg(VariadicTransform):
    # Avg(a, Avg(b, c)) != Avg(Avg(a, b), c), so not a reduce over an op.
    def _emit(self, ctx):
        values = [ctx.value(p).to(config.float_dtype()) for p in self.parents]
        return functools.reduce(operator.add, values) / len(values)


class NoOp(VariadicTransform):
    """Sample all ancestor variables, but produce no value itself."""

    def _emit(self, ctx):
        for p in self.parents:
            ctx.value(p)
        return None


class BinaryTransform(Transform):
    def __init__(self, *args):
        self.parents = tuple(python_to_prob(arg) for arg in args)
        super().__init__()

    def get_parents(self):
        yield from self.parents

    def _rewire(self, update):
        self.parents = tuple(update(p) for p in self.parents)

    def _emit(self, ctx):
        a, b = (ctx.value(p) for p in self.parents)
        return type(self).op(a, b)


class FloorDivide(BinaryTransform):
    # Integers by zero: -1 for 0 // 0, else -2 (XLA's -1 quotient, floored).
    op = staticmethod(
        _integer_division(torch.floor_divide, lambda a: torch.where(a == 0, -1, -2).to(a.dtype))
    )


class Mod(BinaryTransform):
    # jnp.mod takes the divisor's sign: torch.remainder, not torch.fmod.
    # Integers by zero give 0.
    op = staticmethod(_integer_division(torch.remainder, torch.zeros_like))


class Divide(BinaryTransform):
    op = staticmethod(_true_divide)


class Power(BinaryTransform):
    op = staticmethod(_power)


class Subtract(BinaryTransform):
    op = staticmethod(_subtract)


class Equal(BinaryTransform):
    op = staticmethod(torch.eq)


class NotEqual(BinaryTransform):
    op = staticmethod(torch.ne)


class LessThan(BinaryTransform):
    op = staticmethod(torch.lt)


class LessThanOrEqual(BinaryTransform):
    op = staticmethod(torch.le)


class GreaterThan(BinaryTransform):
    op = staticmethod(torch.gt)


class GreaterThanOrEqual(BinaryTransform):
    op = staticmethod(torch.ge)


class IsClose(BinaryTransform):
    # jnp.isclose defaults: rtol=1e-5, atol=1e-8.
    op = staticmethod(_isclose)


class Arctan2(BinaryTransform):
    op = staticmethod(_arctan2)


class UnaryTransform(Transform):
    def __init__(self, arg):
        self.parent = python_to_prob(arg)
        super().__init__()

    def get_parents(self):
        yield self.parent

    def _rewire(self, update):
        self.parent = update(self.parent)

    def _emit(self, ctx):
        return type(self).op(ctx.value(self.parent))


class Negate(UnaryTransform):
    op = staticmethod(operator.neg)


class Abs(UnaryTransform):
    op = staticmethod(_bool_is_fixed(torch.abs))


class Log(UnaryTransform):
    op = staticmethod(_float_op(torch.log))


class Exp(UnaryTransform):
    op = staticmethod(_float_op(torch.exp))


class Floor(UnaryTransform):
    op = staticmethod(_bool_is_fixed(torch.floor))


class Ceil(UnaryTransform):
    op = staticmethod(_bool_is_fixed(torch.ceil))


class Sign(UnaryTransform):
    op = staticmethod(_sign)


class Sqrt(UnaryTransform):
    op = staticmethod(_float_op(torch.sqrt))


class Square(UnaryTransform):
    op = staticmethod(lambda x: torch.square(_bool_as_int(x)))


class Log10(UnaryTransform):
    op = staticmethod(_float_op(torch.log10))


class Sin(UnaryTransform):
    op = staticmethod(_float_op(torch.sin))


class Cos(UnaryTransform):
    op = staticmethod(_float_op(torch.cos))


class Tan(UnaryTransform):
    op = staticmethod(_float_op(torch.tan))


class Arcsin(UnaryTransform):
    op = staticmethod(_float_op(torch.asin))


class Arccos(UnaryTransform):
    op = staticmethod(_float_op(torch.acos))


class Arctan(UnaryTransform):
    op = staticmethod(_float_op(torch.atan))


class Sinh(UnaryTransform):
    op = staticmethod(_float_op(torch.sinh))


class Cosh(UnaryTransform):
    op = staticmethod(_float_op(torch.cosh))


class Tanh(UnaryTransform):
    op = staticmethod(_float_op(torch.tanh))


class Arcsinh(UnaryTransform):
    op = staticmethod(_float_op(torch.asinh))


class Arccosh(UnaryTransform):
    op = staticmethod(_float_op(torch.acosh))


class Arctanh(UnaryTransform):
    op = staticmethod(_float_op(torch.atanh))


class Log1p(UnaryTransform):
    """log(1 + x), exact for |x| near 0."""

    op = staticmethod(_float_op(torch.log1p))


class Expm1(UnaryTransform):
    """exp(x) - 1, exact for |x| near 0."""

    op = staticmethod(_float_op(torch.expm1))


def _numpy_dtype(dtype):
    """``dtype`` (a torch or numpy dtype, or a name) as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _torch_dtype(dtype):
    """``dtype`` (a torch or numpy dtype, or a name) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty((0,), _numpy_dtype(dtype))).dtype


def _untraceable(exc):
    """Is ``exc`` torch.vmap refusing the function (data-dependent control
    flow, ``.item()`` and ``float()``, numpy on a batched tensor), rather
    than the function failing?"""
    message = str(exc)
    return isinstance(exc, RuntimeError) and (
        message.startswith("vmap: It looks like you're")
        or message.startswith("Cannot access data pointer of Tensor that doesn't have storage")
    )


class ScalarFunctionTransform(Transform):
    """Monte Carlo through an arbitrary scalar Python function.

    The function is first mapped with ``torch.vmap``: where it traces, it
    runs as tensor operations on the samples' device.  A function that
    ``torch.vmap`` cannot map (data-dependent Python control flow,
    ``float()`` of a value, numpy calls) runs the per-sample host loop,
    with a warning, as the JAX package's ``pure_callback`` does; its
    result, in ``dtype`` (default ``config.np_float_dtype()``), goes back
    to the samples' device.
    """

    def __init__(self, func, args, kwargs, dtype=None):
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.dtype = dtype
        super().__init__()

    def get_parents(self):
        for arg in self.args + tuple(self.kwargs.values()):
            if isinstance(arg, Node):
                yield arg

    def _rewire(self, update):
        # update() on every item, Node or not: non-Node arguments are
        # deep-copied, so a mutable argument is not shared by a graph and
        # its copy.
        self.args = tuple(update(a) for a in self.args)
        self.kwargs = {k: update(v) for k, v in self.kwargs.items()}

    @staticmethod
    def _static_arg_token(v):
        """Stable token for a non-Node argument: numpy truncates long array
        reprs (two tables would collide) and default object reprs hold
        memory addresses (a fingerprint would differ across processes)."""
        if isinstance(v, Node):
            return "<node>"
        if isinstance(v, np.ndarray):
            return ("ndarray", v.shape, str(v.dtype), v.tobytes())
        r = repr(v)
        if " at 0x" in r:
            return ("object", type(v).__qualname__)
        return r

    def _static_signature(self):
        # The static arguments and the Node/static layout are structure:
        # st(x, 2) and st(x, 3), or f(x, node) and f(node, x), differ.
        arg_layout = tuple(self._static_arg_token(a) for a in self.args)
        kwarg_layout = tuple(
            (k, self._static_arg_token(v)) for k, v in sorted(self.kwargs.items())
        )
        return ("ScalarFunctionTransform", id(self.func), str(self.dtype), arg_layout,
                kwarg_layout)

    def _emit(self, ctx):
        node_args = [a for a in self.args if isinstance(a, Node)]
        node_kwargs = [v for v in self.kwargs.values() if isinstance(v, Node)]
        arrays = [ctx.value(a) for a in node_args + node_kwargs]

        def call_scalar(*scalars):
            it = iter(scalars)
            args = [next(it) if isinstance(a, Node) else a for a in self.args]
            kwargs = {k: (next(it) if isinstance(v, Node) else v) for k, v in self.kwargs.items()}
            return self.func(*args, **kwargs)

        if not arrays:
            # Constant-only arguments: one value, broadcast.
            dtype = config.float_dtype() if self.dtype is None else _torch_dtype(self.dtype)
            return torch.as_tensor(call_scalar(), dtype=dtype, device=ctx.device).expand(ctx.n)

        # Only torch.vmap's refusals and trace-time TypeError or
        # NotImplementedError select the host loop; any other exception
        # (a ValueError, a shape error) is a bug in the function and
        # surfaces here.
        try:
            # An output that does not depend on the samples is broadcast,
            # as jax.vmap broadcasts it.
            return torch.vmap(lambda *s: torch.as_tensor(call_scalar(*s)))(*arrays)
        except (RuntimeError, TypeError, NotImplementedError) as exc:
            if isinstance(exc, RuntimeError) and not _untraceable(exc):
                raise
            fname = getattr(self.func, "__name__", self.func)
            if isinstance(exc, RuntimeError):
                detail = "is not traceable by torch.vmap"
            else:
                # A TypeError can mean an untraceable function or a bug:
                # show it, so that a bug is visible here.
                detail = (
                    "raised at trace time "
                    f"({type(exc).__name__}: {str(exc)[:200]}) — if this "
                    "points at a bug in the function, the host loop will "
                    "raise it again at sampling time"
                )
            warnings.warn(
                f"scalar_transform function {fname!r} {detail}; falling back "
                "to the per-sample host loop (orders of magnitude slower).",
                stacklevel=2,
            )

        out_dtype = config.np_float_dtype() if self.dtype is None else _numpy_dtype(self.dtype)
        host = [a.detach().cpu().numpy() for a in arrays]
        values = np.array([call_scalar(*row) for row in zip(*host)], dtype=out_dtype)
        return torch.from_numpy(values).to(ctx.device)


def scalar_transform(func=None, *, dtype=None):
    """Decorator turning ``f(scalars) -> scalar`` into a graph node factory;
    ``dtype`` is the output dtype of the host loop (and of a function of
    constants alone)."""

    def decorate(f):
        @functools.wraps(f)
        def transformed_function(*args, **kwargs):
            return ScalarFunctionTransform(f, args, kwargs, dtype=dtype)

        return transformed_function

    if func is None:
        return decorate
    return decorate(func)
