"""The rest of the port's core graph API, on the CPU, against the JAX package.

``scalar_transform`` through ``sample_from_quantiles`` on one quantile
matrix in both packages (within 4 float32 ulps, in float32 and in
float64: the two packages' ppfs and arithmetic round alike to within an
ulp or two, and the functions here have no cancellation), the per-sample host loop with its warning (its
values computed by the same Python code on the same float32 inputs),
constant-only arguments, a buggy function surfacing, the signature tokens
and the checkpoint fingerprint, ``interop.from_reference`` of a scalar
node, and ``cuda_exec.supports`` refusing one.  ``GarbageCollector``,
``zip_args``, ``adjust_minmax_quantiles``, ``num_distribution_nodes``,
``_is_initial_sampling_node`` and ``to_graph`` against the JAX package on
the same graphs and inputs (exact: host code on the same values).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu import config as jax_config
from probabilit_tpu.garbage_collector import GarbageCollector as JaxGarbageCollector
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.models import graph as jax_graph
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu.utils import helpers as jax_helpers
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import checkpoint, cuda_exec, streaming
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.garbage_collector import GarbageCollector
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.models.graph import (
    Constant,
    Exp,
    ScalarFunctionTransform,
    scalar_transform,
    topological_sort,
)
from probabilit_tpu_torch.utils import helpers
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

ULPS = 4  # float32 ulps between the packages (see the module docstring)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.fixture(params=["float32", "float64"])
def both_dtypes(request):
    """Both packages in one float mode (JAX's float64 is ``jax_enable_x64``)."""
    config.set_dtype(getattr(torch, request.param))
    jax_config.set_dtype(getattr(jnp, request.param))
    try:
        yield np.dtype(request.param)
    finally:
        config.set_dtype(torch.float32)
        jax_config.set_dtype(jnp.float32)


def _quantiles(n, d, seed=0):
    """A float32-exact quantile grid in (0, 1)."""
    return np.random.default_rng(seed).integers(1, 2**23, (n, d)) / 2**23


def _within_ulps(got, want, dtype=np.float32, ulps=ULPS):
    """Within ``ulps`` float32 ulps of the JAX package's value, in either
    float mode (in float64 the two packages' ppfs differ by tens of
    float64 ulps, far inside this)."""
    assert got.dtype == want.dtype == dtype
    tol = ulps * np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want) / tol)


def _both(build):
    """``build(lib)`` on the JAX package's nodes, and its port."""
    ref = build(jax_graph, JaxDistribution)
    return ref, interop.from_reference(ref)[ref._id]


# --- scalar_transform ------------------------------------------------------------------


def poly(x, y, k=2.0):
    return x * y + k * x * x + 1.0


def test_traceable_function_matches_the_jax_package(both_dtypes):
    """torch.vmap and jax.vmap of the same function on one quantile matrix."""
    ref, port = _both(lambda g, D: g.scalar_transform(poly)(
        D("uniform", loc=1.0, scale=3.0), D("expon", scale=0.5), k=3.0) + 2.0)
    q = _quantiles(4096, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # traceable: no host loop in either package
        want = np.asarray(ref.sample_from_quantiles(q))
        got = port.sample_from_quantiles(q)
    _within_ulps(got.numpy(), want, both_dtypes)


def test_vmapped_equals_the_same_expression_with_operators():
    @scalar_transform
    def f(a, b):
        return a * b + 1

    x = Distribution("norm")
    y = Distribution("lognorm", s=0.5)
    s = f(x, y).sample(4096, random_state=0)
    torch.testing.assert_close(s, x.samples_ * y.samples_ + 1, rtol=0, atol=0)
    # A function whose value does not depend on the samples is broadcast.
    assert torch.equal(scalar_transform(lambda a: 2.5)(x).sample(8, random_state=0),
                       torch.full((8,), 2.5))


@pytest.mark.parametrize("case", ["branch", "numpy", "float"])
def test_host_loop_warns_and_matches_the_jax_package(case, both_dtypes):
    def branch(x, y):
        if x > 1.5:
            return x * y
        return 0.0

    def through_numpy(x, y):
        return np.sin(x) * y

    def through_float(x, y):
        return float(x) ** 2 + y

    fn = {"branch": branch, "numpy": through_numpy, "float": through_float}[case]
    ref, port = _both(lambda g, D: g.scalar_transform(fn)(
        D("uniform", loc=1.0, scale=1.0), D("expon", scale=2.0)))
    q = _quantiles(512, 2, seed=1)
    with pytest.warns(UserWarning, match="per-sample host loop"):
        want = np.asarray(ref.sample_from_quantiles(q))
    with pytest.warns(UserWarning, match="is not traceable by torch.vmap.*per-sample host loop"):
        got = port.sample_from_quantiles(q)
    assert got.device.type == "cpu"
    _within_ulps(got.numpy(), want, both_dtypes)


def test_host_loop_dtype():
    @scalar_transform(dtype=np.float64)
    def wide(x):
        return float(x) / 3.0

    x = Distribution("uniform")
    with pytest.warns(UserWarning, match="host loop"):
        s = wide(x).sample(64, random_state=0)
    assert s.dtype == torch.float64
    np.testing.assert_array_equal(s.numpy(), x.samples_.double().numpy() / 3.0)


def test_constant_only_arguments_broadcast():
    @scalar_transform
    def f(a, b):
        return a * b

    norm = Distribution("norm")
    expr = f(2.0, 3.0) + norm
    s = expr.sample(50, random_state=0)
    torch.testing.assert_close(s, norm.samples_ + 6.0, rtol=1e-6, atol=0)
    ref, port = _both(lambda g, D: g.scalar_transform(lambda a, b: a - b)(5.0, b=1.5)
                      + D("uniform"))
    q = _quantiles(64, 1, seed=2)
    np.testing.assert_array_equal(port.sample_from_quantiles(q).numpy(),
                                  np.asarray(ref.sample_from_quantiles(q)))


def test_non_node_arguments():
    @scalar_transform
    def f(a, factor, shift=0.0):
        return a * factor + shift

    x = Distribution("norm")
    s = f(x, 3.0, shift=Constant(1.0)).sample(100, random_state=0)
    torch.testing.assert_close(s, x.samples_ * 3.0 + 1.0, rtol=1e-6, atol=1e-6)


def test_a_bug_in_the_function_surfaces():
    @scalar_transform
    def raises(a):
        raise ValueError("bug in the function")

    @scalar_transform
    def bad_shape(a):
        return a @ torch.ones(3)

    x = Distribution("norm")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no silent fall back to the host loop
        with pytest.raises(ValueError, match="bug in the function"):
            raises(x).sample(8, random_state=0)
        with pytest.raises(RuntimeError, match="matmul"):
            bad_shape(x).sample(8, random_state=0)


def test_trace_time_type_error_is_shown_then_raised_again():
    @scalar_transform
    def bad(a):
        return "a" + a

    node = bad(Distribution("norm"))
    with pytest.warns(UserWarning, match="raised at trace time \\(TypeError"):
        with pytest.raises(TypeError):
            node.sample(8, random_state=0)


def test_streamed_estimate_and_estimate_many_run_the_function():
    @scalar_transform
    def payoff(s, k):
        return (s - k) * (s > k)

    s = Distribution("lognorm", s=0.25, scale=100.0)
    call = payoff(s, 100.0)
    one = streaming.estimate(call, 1 << 14, block_size=1 << 12, random_state=0)
    many = streaming.estimate_many([s, call], 1 << 14, block_size=1 << 12, random_state=0)
    assert one["mean"] == pytest.approx(many[call]["mean"], rel=0.05)
    assert many[call]["min"] == 0.0


# --- Signatures, fingerprint, interop and the kernels' refusal --------------------------


def test_static_arg_tokens_match_the_jax_package():
    values = [2.5, "table", (1, 2), np.arange(2000.0), object(), None, [1.0, 2.0]]
    for v in values:
        assert ScalarFunctionTransform._static_arg_token(v) == (
            jax_graph.ScalarFunctionTransform._static_arg_token(v))
    assert ScalarFunctionTransform._static_arg_token(Distribution("norm")) == "<node>"


def test_signature_and_from_reference():
    table = np.linspace(0.0, 1.0, 5)

    def f(a, b, table, scale=1.0):
        return (a * a + b) * scale

    ref = jax_graph.scalar_transform(f, dtype=np.float32)(
        JaxDistribution("norm"), 2.0, table, scale=JaxDistribution("uniform"))
    mapping = interop.from_reference(ref)
    port = mapping[ref._id]
    assert isinstance(port, ScalarFunctionTransform)
    assert port.func is f and port.dtype is np.float32
    assert port.args[0] is mapping[ref.args[0]._id] and port.args[1] == 2.0
    np.testing.assert_array_equal(port.args[2], table)
    assert port.kwargs["scale"] is mapping[ref.kwargs["scale"]._id]
    assert port._static_signature() == ref._static_signature()
    assert [p._id for p in port.get_parents()] == [mapping[p._id]._id for p in ref.get_parents()]
    q = _quantiles(256, 2, seed=3)
    _within_ulps(port.sample_from_quantiles(q).numpy(), np.asarray(ref.sample_from_quantiles(q)))


def test_fingerprint_signs_by_qualname_and_static_arguments():
    def make():
        @scalar_transform
        def f(a, b):
            return a + b

        return f

    x = Distribution("norm")
    f1, f2 = make(), make()  # two function objects, one qualname
    assert checkpoint.graph_fingerprint(f1(x, 2.0)) == checkpoint.graph_fingerprint(f2(x, 2.0))
    assert f1(x, 2.0)._static_signature() != f2(x, 2.0)._static_signature()  # id(func)
    assert checkpoint.graph_fingerprint(f1(x, 2.0)) != checkpoint.graph_fingerprint(f1(x, 3.0))
    assert checkpoint.graph_fingerprint(f1(x, 2.0)) != checkpoint.graph_fingerprint(f1(2.0, x))
    g = scalar_transform(lambda a, b: a * b)
    assert checkpoint.graph_fingerprint(g(x, 2.0)) != checkpoint.graph_fingerprint(f1(x, 2.0))
    t1 = np.arange(2000.0)
    t2 = t1.copy()
    t2[1200] = -1.0
    assert checkpoint.graph_fingerprint(f1(x, t1)) != checkpoint.graph_fingerprint(f1(x, t2))
    assert checkpoint.graph_fingerprint(f1(x, object())) == checkpoint.graph_fingerprint(
        f1(x, object()))


def test_cuda_exec_refuses_a_scalar_transform():
    sink = scalar_transform(lambda a: a * 2.0)(Distribution("norm")) + 1.0
    plan = tcompile.get_plan(sink)
    assert not cuda_exec.supports(plan, frozenset({sink._id}))
    plain = Distribution("norm") * 2.0 + 1.0  # the same graph with operators
    assert cuda_exec.supports(tcompile.get_plan(plain), frozenset({plain._id}))
    with pytest.raises(ValueError, match="scalar_transform"):
        sink.sample(100, random_state=0, gc_strategy=[], executor="cuda")
    with pytest.raises(ValueError, match="not eligible for executor='cuda'"):
        streaming.estimate(sink, 1000, block_size=256, executor="cuda")
    # "auto" runs the plain executor, as the JAX package runs XLA.
    assert streaming.estimate(sink, 1000, block_size=256, random_state=0)["n"] == 1000


def test_copy_rewires_and_deep_copies_static_arguments():
    @scalar_transform
    def pick(a, weights):
        return a * weights[0]

    x = Distribution("norm")
    weights = [2.0]
    node = pick(x, weights) + x
    dup = node.copy()
    scalar = next(p for p in dup.get_parents() if isinstance(p, ScalarFunctionTransform))
    assert scalar.args[0] is not x and scalar.args[0]._id == x._id
    assert scalar.args[1] == weights and scalar.args[1] is not weights
    torch.testing.assert_close(dup.sample(16, random_state=0), node.sample(16, random_state=0))


# --- GarbageCollector ------------------------------------------------------------------


def _manual_sample(sink, gc, nodes):
    """Drive a GC through a manual topological pass; the released nodes."""
    gc.set_sink(sink)
    released = []
    for node in nodes(sink):
        node.samples_ = np.zeros(3)
        released.extend(gc.decrement_and_delete(node))
    return released


def _gc_graphs(g, D):
    a = D("norm")
    inter = (a + a) ** 2
    return {"chain": g.Exp(inter), "shared": inter * inter + a}


@pytest.mark.parametrize("graph", ["chain", "shared", "mixed_dag_20"])
@pytest.mark.parametrize("strategy", ["none", "empty", "protect"])
def test_garbage_collector_matches_the_jax_package(graph, strategy):
    if graph == "mixed_dag_20":
        ref = jax_benchmarks.mixed_dag_20()
    else:
        ref = _gc_graphs(jax_graph, JaxDistribution)[graph]
    mapping = interop.from_reference(ref)
    port = mapping[ref._id]
    ref_topo = jax_graph.topological_sort(ref)
    protect = {"none": None, "empty": [], "protect": ref_topo[len(ref_topo) // 2 : -1 : 2]}[strategy]
    ref_gc = JaxGarbageCollector(protect)
    port_gc = GarbageCollector(None if protect is None else [mapping[n._id] for n in protect])
    want = _manual_sample(ref, ref_gc, jax_graph.topological_sort)
    got = _manual_sample(port, port_gc, topological_sort)
    assert [mapping[n._id] for n in want] == got
    if protect is not None:
        assert {mapping[n._id]: c for n, c in ref_gc._edges_left.items()} == dict(
            port_gc._edges_left)
    kept = {n._id for n in ref_topo if hasattr(n, "samples_")}
    assert {n._id for n in topological_sort(port) if hasattr(n, "samples_")} == {
        mapping[i]._id for i in kept}


def test_garbage_collector_large_graph_and_deep_chain():
    total = Constant(0)
    rate = Distribution("norm", loc=1.01, scale=0.01)
    for _ in range(99):
        total = total * rate + 100
    _manual_sample(total, GarbageCollector(strategy=[rate]), topological_sort)
    assert sum(1 for node in total.unique_nodes() if hasattr(node, "samples_")) == 2
    x = Distribution("norm")
    for _ in range(40):
        x = x + x
    gc = GarbageCollector(strategy=[]).set_sink(x)  # 2^40 paths: propagated, not walked
    assert gc._edges_left[next(iter(x.get_parents()))] == 2


def test_garbage_collector_validation():
    with pytest.raises(ValueError, match="set_sink"):
        GarbageCollector(strategy=[]).decrement_and_delete(Constant(1))
    with pytest.raises(TypeError):
        GarbageCollector(strategy=42)


# --- helpers ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "args, kwargs",
    [((("x", "y"),), {"n": (10, 20)}), (((1, 2, 3), (4, 5)), {}), ((), {"a": (1, 2)}), ((), {})],
)
def test_zip_args_matches_the_jax_package(args, kwargs):
    want = list(jax_helpers.zip_args(args, kwargs))
    got = list(helpers.zip_args(args, kwargs))
    assert got == want


@pytest.mark.parametrize(
    "quantiles, cumulatives, expected",
    [([0, 0.5, 1], [0, 5, 6], 4.0), ([0, 0.5, 1], [0, 5, 6], 5.0),
     ([0, 0.1, 0.5, 0.9, 1], [1.0, 2.0, 4.0, 7.0, 9.0], 4.5)],
)
def test_adjust_minmax_quantiles_matches_the_jax_package(quantiles, cumulatives, expected):
    want = jax_helpers.adjust_minmax_quantiles(quantiles, cumulatives, expected)
    got = helpers.adjust_minmax_quantiles(quantiles, cumulatives, expected)
    np.testing.assert_array_equal(got, want)
    assert helpers._histogram_mean(quantiles, got) == jax_helpers._histogram_mean(quantiles, want)


# --- Node helpers ----------------------------------------------------------------------


def _node_graphs():
    def composite(g, D):
        n = D("poisson", mu=4.0)
        p = D("uniform", loc=0.2, scale=0.5)
        return D("binom", n=n, p=p) + g.Exp(D("norm"))

    return {
        "mixed_dag_20": jax_benchmarks.mixed_dag_20(),
        "composite": composite(jax_graph, JaxDistribution),
        "constant": jax_graph.Constant(3.0),
    }


@pytest.mark.parametrize("name", ["mixed_dag_20", "composite", "constant"])
def test_node_helpers_match_the_jax_package(name):
    ref = _node_graphs()[name]
    mapping = interop.from_reference(ref)
    for node in jax_graph.topological_sort(ref):
        port = mapping[node._id]
        assert port.num_distribution_nodes() == node.num_distribution_nodes()
        assert port._is_initial_sampling_node() == node._is_initial_sampling_node()
    want = ref.to_graph()
    got = mapping[ref._id].to_graph()
    to_ref = {port._id: rid for rid, port in mapping.items()}
    assert sorted((to_ref[u._id], to_ref[v._id]) for u, v, _ in got.edges) == sorted(
        (u._id, v._id) for u, v, _ in want.edges)
    assert got.number_of_nodes() == want.number_of_nodes()


def test_to_graph_on_shared_subexpressions():
    a, b = Distribution("norm"), Distribution("norm")
    x = a + b
    for _ in range(26):
        x = x + x
    x.correlate(a, b, corr_mat=np.eye(2))
    assert x.num_distribution_nodes() == 2
    assert a._is_initial_sampling_node() and not x._is_initial_sampling_node()
    g = x.to_graph()
    assert g.number_of_nodes() == 26 + 3  # 26 Adds + the first Add + a + b
    assert g.number_of_edges() == 2 * 27  # each Add's two parent edges
    assert Exp(Constant(1.0)).to_graph().number_of_nodes() == 2
