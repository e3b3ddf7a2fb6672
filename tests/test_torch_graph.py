"""The port's graph layer against the JAX package.

Every transform's ``_emit`` runs on the same seeded numpy inputs in both
packages.  Floats agree to 4 float32 ulps of the larger of the value and
1, since XLA's and PyTorch's math libraries differ in the last bits.
Booleans and integers agree exactly, and so do the result types.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu import config as jax_config
from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.models import graph as jg
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.models import graph as tg
from probabilit_tpu_torch.models.distributions import Distribution


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch CPU ops on one thread.

    The suite runs in several worker processes at once.  With torch's
    default of one OpenMP thread per core in each, the workers' threads
    outnumber the cores several times over, and a thread that waits at a
    parallel region's barrier for peers that are not scheduled holds its
    core: the port's files then run many times slower than alone.  One
    thread a worker keeps the suite within the cores.  Every port test file
    imports this fixture."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(previous)


@pytest.fixture(scope="module", autouse=True)
def vector_math_initialised():
    """One call of each vectorised math function on a single thread first.

    torch's CPU float ops split a tensor into 2048-element chunks across
    OpenMP threads.  When the first such call in a fresh process runs on
    two threads at once (a 4096-element ``torch.log``), the second chunk
    has come back wrong by up to 4e-5 (about 1 process in 100 to 500 with
    the CPU build of torch 2.13, MKL inside): the vector math initialises
    itself lazily, and racily.  Under ``-n 6 --dist loadfile`` this file
    can be the first on its worker, so it sets that state up itself
    rather than inherit it from whichever file ran before."""
    one = torch.ones(1)
    for fn in (torch.log, torch.log10, torch.log1p, torch.exp, torch.expm1, torch.sqrt,
               torch.sin, torch.cos, torch.tan, torch.asin, torch.acos, torch.atan,
               torch.sinh, torch.cosh, torch.tanh, torch.asinh, torch.atanh):
        fn(0.5 * one)
    torch.acosh(2.0 * one)
    torch.atan2(one, one)


N = 4096
ULP_TOL = 4


class _Ctx:
    """A minimal emit context: given values for some nodes, emits the rest."""

    def __init__(self, values, device=None):
        self.n = N
        self.device = device
        self._values = dict(values)

    def value(self, node):
        if node._id not in self._values:
            self._values[node._id] = node._emit(self)
        return self._values[node._id]


def _inputs(name, rng):
    """Seeded float32 inputs inside each transform's domain."""
    normal = rng.normal(size=(3, N))
    unit = rng.random((3, N))
    if name in ("Log", "Sqrt", "Log10", "Log1p"):
        xs = [0.1 + 5.0 * unit[0]]
    elif name in ("Arcsin", "Arccos", "Arctanh"):
        xs = [-0.95 + 1.9 * unit[0]]
    elif name == "Arccosh":
        xs = [1.05 + 4.0 * unit[0]]
    elif name == "Tan":
        xs = [-1.4 + 2.8 * unit[0]]
    elif name in ("FloorDivide", "Mod"):
        # Divisors of both signs pin jnp's floor semantics.
        xs = [5.0 * normal[0], (0.5 + 2.0 * unit[1]) * np.sign(normal[1])]
    elif name == "Power":
        xs = [0.1 + 3.0 * unit[0], normal[1]]
    elif name == "IsClose":
        xs = [normal[0], normal[0] * (1.0 + 1e-5 * normal[1])]
    elif name == "Equal":
        xs = [normal[0], np.where(unit[1] < 0.5, normal[0], normal[0] + 1.0)]
    elif name in ("All", "Any"):
        xs = [np.where(unit[i] < 0.3, 0.0, normal[i]) for i in range(3)]
    else:
        xs = [2.0 * normal[0], 2.0 * normal[1], 2.0 * normal[2]]
    return [x.astype(np.float32) for x in xs]


VARIADIC = ["Add", "Multiply", "Max", "Min", "All", "Any", "Avg", "NoOp"]
BINARY = [
    "FloorDivide", "Mod", "Divide", "Power", "Subtract", "Equal", "NotEqual",
    "LessThan", "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual",
    "IsClose", "Arctan2",
]
UNARY = [
    "Negate", "Abs", "Log", "Exp", "Floor", "Ceil", "Sign", "Sqrt", "Square",
    "Log10", "Sin", "Cos", "Tan", "Arcsin", "Arccos", "Arctan", "Sinh", "Cosh",
    "Tanh", "Arcsinh", "Arccosh", "Arctanh", "Log1p", "Expm1",
]
ARITY = {**{n: 3 for n in VARIADIC}, **{n: 2 for n in BINARY}, **{n: 1 for n in UNARY}}


def _assert_same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(got, ref)
        return
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(got[~finite], ref[~finite])  # the same inf and nan
    ref, got = ref[finite], got[finite]
    scale = np.maximum(np.abs(ref), 1.0).astype(ref.dtype)
    assert np.all(np.abs(got - ref) <= ULP_TOL * np.spacing(scale))


def test_every_transform_is_parametrised():
    bases = (tg.VariadicTransform, tg.BinaryTransform, tg.UnaryTransform)
    classes = {getattr(tg, n) for n in tg.__all__}
    transforms = {c.__name__ for c in classes
                  if isinstance(c, type) and issubclass(c, bases) and c not in bases}
    assert transforms == set(ARITY) and len(ARITY) == 45


@pytest.mark.parametrize("name", list(ARITY))
def test_transform_matches_jax_emit(name):
    xs = _inputs(name, np.random.default_rng(zlib.crc32(name.encode())))[: ARITY[name]]
    jax_parents = [jg.Constant(0.0) for _ in xs]
    port_parents = [tg.Constant(0.0) for _ in xs]
    ref = getattr(jg, name)(*jax_parents)._emit(
        _Ctx({p._id: jnp.asarray(x) for p, x in zip(jax_parents, xs)})
    )
    got = getattr(tg, name)(*port_parents)._emit(
        _Ctx({p._id: torch.from_numpy(x) for p, x in zip(port_parents, xs)})
    )
    if name == "NoOp":
        assert ref is None and got is None
        return
    _assert_same(ref, got)


INTEGER_CASES = [
    ("FloorDivide", (7, -2)),
    ("Mod", (7, -2)),
    ("Mod", (-7, 2)),
    ("Power", (2, 10)),
    ("Add", (True, True)),
    ("Max", (2, 5)),
    ("Divide", (7, 2)),
    ("Avg", (1, 2)),
    ("LessThan", (1, 2)),
    ("Exp", (1,)),
    ("Abs", (-3,)),
    ("Floor", (3,)),
    ("Sign", (-3,)),
    ("Multiply", (3, 0.5)),
    ("Subtract", (1, 0.25)),
    ("Subtract", (0.5, True)),
    ("Subtract", (True, 2)),
    ("IsClose", (1, 1.0000001)),
]


@pytest.mark.parametrize("name,values", INTEGER_CASES,
                         ids=[f"{n}{v}" for n, v in INTEGER_CASES])
def test_constant_types_follow_jnp(name, values):
    ref = getattr(jg, name)(*[jg.Constant(v) for v in values])._emit(_Ctx({}))
    got = getattr(tg, name)(*[tg.Constant(v) for v in values])._emit(_Ctx({}))
    _assert_same(ref, got)


def _emit_both(name, xs):
    """``name``'s ``_emit`` on the numpy inputs ``xs`` in both packages; the
    JAX package's result is None where it refuses the operand types."""
    jax_parents = [jg.Constant(0.0) for _ in xs]
    port_parents = [tg.Constant(0.0) for _ in xs]
    port = getattr(tg, name)(*port_parents)
    port_ctx = _Ctx({p._id: torch.from_numpy(x) for p, x in zip(port_parents, xs)})
    try:
        ref = getattr(jg, name)(*jax_parents)._emit(
            _Ctx({p._id: jnp.asarray(x) for p, x in zip(jax_parents, xs)})
        )
    except TypeError:
        return None, port, port_ctx
    return ref, port, port_ctx


@pytest.fixture(params=["float32", "float64"])
def both_dtypes(request):
    """Both packages in one float mode (JAX's float64 is ``jax_enable_x64``)."""
    config.set_dtype(getattr(torch, request.param))
    jax_config.set_dtype(getattr(jnp, request.param))
    try:
        yield request.param
    finally:
        config.set_dtype(torch.float32)
        jax_config.set_dtype(jnp.float32)


# Functions of bools that jnp computes in int32 in either float mode.
BOOL_INT32 = ("FloorDivide", "Mod", "Power", "Square")


@pytest.mark.parametrize("name", [n for n in ARITY if n != "NoOp"])
def test_transform_on_bool_inputs_matches_jax(name, both_dtypes):
    # jnp keeps abs, floor and ceil of a bool as bool, computes //, % and
    # ** of bools in int32 (a False divisor as an integer zero), and a
    # float function of bools in float32, under x64 too.
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    xs = [rng.random(N) < 0.5 for _ in range(ARITY[name])]
    ref, port, ctx = _emit_both(name, xs)
    if ref is None:  # jnp refuses bool here (neg, sign, bool - bool): no value to match
        assert name in ("Negate", "Sign", "Subtract")
        return
    got = port._emit(ctx)
    _assert_same(ref, got)
    if name in BOOL_INT32:
        assert got.dtype == torch.int32


def test_exp_of_a_bool_is_float32_in_both_modes(both_dtypes):
    # ROADMAP's C5 input: under x64 the port computed exp(True) in float64.
    q = np.array([[0.2], [0.7]])
    ref = JaxDistribution("norm") > 0
    port = Distribution("norm") > 0
    ref_out = np.asarray(jg.Exp(ref).sample_from_quantiles(q))
    got = tg.Exp(port).sample_from_quantiles(q)
    assert ref_out.dtype == np.float32 and got.dtype == torch.float32
    assert got.tolist() == ref_out.tolist() == [1.0, 2.7182817459106445]


ZERO_DIVISOR_CASES = {
    "roadmap": ([-3, 0, 2, 7], [2, 0, -3, 0]),
    "seeded": None,
    "extremes": ([-(2**31), 2**31 - 1, -(2**31), 5, 0], [0, 0, -1, -1, 0]),
}


@pytest.mark.parametrize("case", list(ZERO_DIVISOR_CASES))
@pytest.mark.parametrize("name", ["FloorDivide", "Mod"])
def test_integer_division_by_zero_matches_jax(name, case):
    if ZERO_DIVISOR_CASES[case] is None:
        rng = np.random.default_rng(zlib.crc32(name.encode()) + 2)
        a, b = rng.integers(-9, 10, N), rng.integers(-2, 3, N)  # a fifth of the divisors are 0
    else:
        a, b = ZERO_DIVISOR_CASES[case]
    xs = [np.asarray(a, np.int32), np.asarray(b, np.int32)]
    ref, port, ctx = _emit_both(name, xs)
    got = port._emit(ctx)
    _assert_same(ref, got)
    if case == "roadmap":
        expected = {"FloorDivide": [-2, -1, -1, -2], "Mod": [1, 0, -1, 0]}[name]
        assert got.tolist() == expected


def test_integer_power_matches_jax_for_non_negative_exponents():
    # Negative integer exponents are left out: jnp's values there are the
    # reference's own defect (3 ** -2 = 703701817 on int32).
    rng = np.random.default_rng(5)
    xs = [rng.integers(-5, 6, N).astype(np.int32), rng.integers(0, 6, N).astype(np.int32)]
    ref, port, ctx = _emit_both("Power", xs)
    _assert_same(ref, port._emit(ctx))


def _expression(mod, x, y):
    return [
        x + 1, 1 + x, x * y, 2 * y, x - y, 3 - x, x / y, 1 / y, x // 2, 7 // y,
        x % 2, 5 % y, x**2, 2**y, -x, abs(y), x < y, x <= 0.5, x > y, y >= x,
        mod.Exp(x) + mod.Sqrt(y),
    ]


def _structure(node):
    name = type(node).__name__
    if name == "Constant":
        return ("Constant", node.value)
    if name == "Distribution":
        return ("Distribution", node.distr)
    return (name, tuple(_structure(p) for p in node.get_parents()))


def test_operator_overloading_builds_the_same_graphs():
    jx, jy = JaxDistribution("uniform"), JaxDistribution("norm")
    tx, ty = Distribution("uniform"), Distribution("norm")
    for ref, got in zip(_expression(jg, jx, jy), _expression(tg, tx, ty)):
        assert _structure(ref) == _structure(got)


def _port_of(jax_sink):
    mapping = interop.from_reference(jax_sink)
    return mapping, mapping[jax_sink._id]


def _composite():
    a = JaxDistribution("uniform", loc=1.0, scale=2.0)
    b = JaxDistribution("norm", loc=a, scale=a * 0.5)
    c = JaxDistribution("expon", scale=b * b + 1)
    return jg.Avg(a, b, c) + JaxDistribution("triang", c=0.3, loc=b, scale=2)


@pytest.mark.parametrize("build", [jax_benchmarks.mixed_dag_20, _composite,
                                   jax_benchmarks.height_model])
def test_topological_sort_and_columns_match_jax(build):
    jax_sink = build()
    mapping, sink = _port_of(jax_sink)
    ref_order = [mapping[n._id]._id for n in jg.topological_sort(jax_sink)]
    assert [n._id for n in tg.topological_sort(sink)] == ref_order
    jax_plan, plan = jax_compile.Plan(jax_sink), tcompile.Plan(sink)
    assert plan.d == jax_plan.d == plan.d_total
    assert {mapping[nid]._id: col for nid, col in jax_plan.col_of.items()} == plan.col_of
    assert [mapping[n._id]._id for n in jax_plan.pre_topo] == [n._id for n in plan.pre_topo]


def test_topological_sort_rejects_cycles():
    a = Distribution("norm")
    b = a + 1
    a.kwargs["loc"] = b
    with pytest.raises(ValueError, match="cycle"):
        tg.topological_sort(b)


def test_unique_nodes_and_nodes():
    x = Distribution("norm")
    s = x + x
    assert {n._id for n in s.unique_nodes()} == {x._id, s._id}
    assert len(list(s.nodes())) == 3  # s, then x once per path


def test_copy_preserves_ids_and_samples():
    x = Distribution("norm", loc=Distribution("uniform"), scale=tg.Constant(0.5))
    s = tg.Exp(x) * 2
    s.sample(64, random_state=0)
    c = s.copy()
    assert c is not s and c._id == s._id
    torch.testing.assert_close(c.samples_, s.samples_)
    assert c.samples_.data_ptr() != s.samples_.data_ptr()
    cx = c.parents[0].parent
    assert cx is not x and cx._id == x._id
    assert cx.kwargs["loc"]._id == x.kwargs["loc"]._id and cx.kwargs["loc"] is not x.kwargs["loc"]


def test_constant_is_idempotent_and_typed():
    assert tg.Constant(tg.Constant(3)).value == 3
    ctx = _Ctx({})
    assert tg.Constant(True)._emit(ctx).dtype == torch.bool
    assert tg.Constant(3)._emit(ctx).dtype == torch.int32
    assert tg.Constant(0.5)._emit(ctx).dtype == torch.float32


def test_python_to_prob_rejects_other_types():
    with pytest.raises(ValueError, match="not compatible"):
        tg.python_to_prob("a")


def test_correlate_waits_for_the_next_slice():
    # correlate() is ported, the Student-t copula correlator with it.
    a, b = Distribution("norm"), Distribution("norm")
    epoch = tg.Node._mutation_epoch
    sink = (a + b).correlate(a, b, corr_mat=np.eye(2))
    assert tg.Node._mutation_epoch == epoch + 1
    variables, corr_mat = sink._correlations[0]
    assert variables == [a, b] and np.array_equal(corr_mat, np.eye(2))
    assert sink.copy()._correlations[0][0][0]._id == a._id
    with pytest.raises(AssertionError):
        sink.correlate(a, b, corr_mat=np.eye(3))
    assert sink.sample(10, random_state=0, correlator="tcopula").shape == (10,)


def _port_modules():
    import pkgutil

    import probabilit_tpu_torch

    return ["probabilit_tpu_torch"] + [
        info.name
        for info in pkgutil.walk_packages(
            probabilit_tpu_torch.__path__, prefix="probabilit_tpu_torch."
        )
    ]


@pytest.mark.parametrize("module_name", _port_modules())
def test_port_doctests(module_name):
    import doctest
    import importlib

    results = doctest.testmod(
        importlib.import_module(module_name),
        optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE,
    )
    assert results.failed == 0
