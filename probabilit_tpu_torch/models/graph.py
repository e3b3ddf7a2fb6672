"""The computational-graph modeling language, evaluated with PyTorch.

Port of ``probabilit_tpu/models/graph.py:104-820``: lazy ``Node`` graphs
built by operator overloading, hashed by a unique monotonic id, sampled by
calling ``.sample(n)`` on any node.  Each node carries its graph structure
(``get_parents``) and ``_emit(ctx)``, which computes the node's samples
from its parents' tensors with the same numeric semantics as the JAX
package (``jnp`` type promotion: integer constants stay integers,
comparisons give booleans).

Not ported yet: ``ScalarFunctionTransform`` / ``scalar_transform``.
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
