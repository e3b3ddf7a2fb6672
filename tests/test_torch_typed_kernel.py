"""K1's int32 and bool values: the typed tape against the JAX package.

On the CPU.  Every value on the tape has a kind, bool, int32 or float32,
as ``jnp`` types the JAX package's nodes.  The twin (``run_tape``, which
``run_program`` equals bitwise) is held against the JAX package's plain
path on the same seeded quantile matrix, cast to float32, exactly: every
int32 and bool operation over the grid of operand kinds, the int32
extremes (``benchmarks.typed_ops``, R7's negative powers left out), and
``breach_count``'s int32 and bool nodes (its float nodes within 1e-4 of
their largest value: the ppfs of the two packages round apart, ROADMAP's
per-node tolerance).  The kinds the lowering gives equal the dtypes the
JAX package emits; ``supports`` equals ``pallas_exec.supports``; int32
constants reach the kernel's parameter block bit for bit; the generated
text types its lines; and a ``NoOp`` or a bool negated fails as on the
plain path.  The kernel itself is held against the twin on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import types

import numpy as np
import pytest
import torch

from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import pallas_exec
from probabilit_tpu.models import graph as jg
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu_torch import _build, config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, streaming
from probabilit_tpu_torch.models import benchmarks, graph as tg
from probabilit_tpu_torch.models.distributions import Distribution
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

N = 512
JAX = types.SimpleNamespace(
    Distribution=JaxDistribution, **{name: getattr(jg, name) for name in jg.__all__ if name[0].isupper()}
)
KIND_OF_DTYPE = {np.dtype(np.bool_): "b", np.dtype(np.int32): "i", np.dtype(np.float32): "f"}


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _quantiles(d, seed):
    """A seeded (N, d) float32 quantile matrix on the generators' grid."""
    return (np.random.default_rng(seed).integers(1, 2**23, (N, d)) / 2**23).astype(np.float32)


def _stored_kinds(tape):
    """The kind of the value each STORE row writes."""
    kind_of = {row[1]: kind for row, kind in zip(tape.program, tape.kinds) if kind is not None}
    store = cuda_exec.OPCODES.index("STORE")
    return [kind_of[row[2]] for row in tape.program if row[0] == store]


def _run_both(jax_sink, leaves, seed=0):
    """{label: (JAX package's values, the twin's float32 row, the
    lowering's kind)} for the nodes ``leaves`` ({label: JAX node}) of one
    graph, on one quantile matrix; the twin runs the leaves 15 at a time
    beside the sink, through ``run_tape`` and ``run_program``."""
    mapping = interop.from_reference(jax_sink)
    sink = mapping[jax_sink._id]
    plan = tcompile.get_plan(sink)
    U = _quantiles(plan.d, seed)
    jax_sink.sample_from_quantiles(U)  # keep-all: every node's samples_
    labels = list(leaves) + ["sink"]
    nodes = {**leaves, "sink": jax_sink}
    out = {}
    for i in range(0, len(labels), 15):
        group = labels[i:i + 15]
        order = cuda_exec.keep_order(plan, frozenset(mapping[nodes[k]._id]._id for k in group) | {sink._id})
        tape = cuda_exec.lower(plan, order)
        got = cuda_exec.run_tape(tape, torch.from_numpy(U))
        torch.testing.assert_close(cuda_exec.run_program(tape, torch.from_numpy(U)), got,
                                   rtol=0, atol=0)
        label_of = {mapping[nodes[k]._id]._id: k for k in group}
        label_of[sink._id] = "sink"
        for k, (nid, kind) in enumerate(zip(order, _stored_kinds(tape))):
            out[label_of[nid]] = (np.asarray(nodes[label_of[nid]].samples_), got[k].numpy(), kind)
    return out


# --- Every int32 and bool operation over the grid of operand kinds ------------------------

BINARY = {
    "Add": lambda g, a, b: g.Add(a, b),
    "Multiply": lambda g, a, b: g.Multiply(a, b),
    "Max": lambda g, a, b: g.Max(a, b),
    "Min": lambda g, a, b: g.Min(a, b),
    "All": lambda g, a, b: g.All(a, b),
    "Any": lambda g, a, b: g.Any(a, b),
    "Subtract": lambda g, a, b: g.Subtract(a, b),
    "FloorDivide": lambda g, a, b: g.FloorDivide(a, b),
    "Mod": lambda g, a, b: g.Mod(a, b),
    "Power": lambda g, a, b: g.Power(a, b),
    "Equal": lambda g, a, b: g.Equal(a, b),
    "NotEqual": lambda g, a, b: g.NotEqual(a, b),
    "LessThan": lambda g, a, b: g.LessThan(a, b),
    "LessThanOrEqual": lambda g, a, b: g.LessThanOrEqual(a, b),
    "GreaterThan": lambda g, a, b: g.GreaterThan(a, b),
    "GreaterThanOrEqual": lambda g, a, b: g.GreaterThanOrEqual(a, b),
    "IsClose": lambda g, a, b: g.IsClose(a, b),
}
UNARY = ("Negate", "Abs", "Floor", "Ceil", "Sign", "Square")
# Operations whose float results round alike in both packages: a float
# operand enters these; //, %, ** and isclose of floats are float math,
# held by the float tests.
WITH_FLOATS = ("Add", "Multiply", "Max", "Min", "All", "Any", "Subtract", "Equal", "NotEqual",
               "LessThan", "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual")
INT_PAIRS = ("bb", "bi", "ib", "ii")
FLOAT_PAIRS = ("bf", "fb", "if", "fi")
# jnp refuses these (bool - bool, -bool, sign of a bool).
REFUSED = {("Subtract", "bb"), ("Negate", "b"), ("Sign", "b")}
CASES = [(op, pair) for op in BINARY for pair in INT_PAIRS + (FLOAT_PAIRS if op in WITH_FLOATS else ())
         if (op, pair) not in REFUSED]
CASES += [(op, kind) for op in UNARY for kind in "bi" if (op, kind) not in REFUSED]


def _grid_operands(g):
    """Two per-sample operands of each kind: bools, int32 values among
    {7, 0, -2} and {3, 0, -2} (divisors 0 and negative, equal and unequal
    pairs), and standard uniforms (no arithmetic before the op: XLA would
    fuse it).  A power's exponent is never negative (R7)."""
    u = [g.Distribution("uniform") for _ in range(6)]
    first = {"b": u[0] > 0.5, "i": (u[2] > 0.5) * 7 + (u[2] < 0.25) * -2, "f": u[4]}
    second = {"b": u[1] > 0.5, "i": (u[3] > 0.66) * 3 + (u[3] < 0.33) * -2, "f": u[5]}
    exponent = (u[3] > 0.5) * 3
    return first, second, exponent


GRID_GRAPHS = 6  # the grid's leaves in six graphs: the twin holds at most 64 live values


def _grid_graph(g, part=0):
    first, second, exponent = _grid_operands(g)
    leaves = {}
    for op, kinds in CASES[part::GRID_GRAPHS]:
        if op in BINARY:
            b = exponent if op == "Power" and kinds[1] == "i" else second[kinds[1]]
            leaves[f"{op}-{kinds}"] = BINARY[op](g, first[kinds[0]], b)
        else:
            leaves[f"{op}-{kinds}"] = getattr(g, op)(first[kinds])
    sink = g.Add(*(leaf * 0 for leaf in leaves.values()))  # every leaf in one graph
    return sink, leaves


@pytest.fixture(scope="module")
def grid():
    previous = config.device()
    config.set_device("cpu")
    try:
        out = {}
        for part in range(GRID_GRAPHS):
            out.update(_run_both(*_grid_graph(JAX, part)))
        return out
    finally:
        config.set_device(previous)


@pytest.mark.parametrize("op,kinds", CASES, ids=[f"{op}-{kinds}" for op, kinds in CASES])
def test_twin_matches_jax_over_the_kind_grid(grid, op, kinds):
    want, got, kind = grid[f"{op}-{kinds}"]
    assert kind == KIND_OF_DTYPE[want.dtype]  # the lowering types the node as jnp does
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_the_grid_reaches_every_typed_body():
    """Every body of ``_TYPED_EMIT`` is generated for the grid's graphs
    (and the sign of a bool, which the port's plain executor keeps and jnp
    refuses)."""
    used = set()
    sinks = [_grid_graph(benchmarks._lib(None), part)[0] for part in range(GRID_GRAPHS)]
    for sink in sinks + [tg.Sign(Distribution("uniform") > 0.5) * 1]:
        tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
        kind_of = {}
        for row, kind in zip(tape.program, tape.kinds):
            name = cuda_exec.OPCODES[row[0]]
            if name in cuda_exec._TRANSFORM_FN:
                operands = [kind_of[v] for v in row[2:] if v >= 0]
                used.add((cuda_exec._compute_kind(name, operands, kind), name))
            if kind is not None:
                kind_of[row[1]] = kind
    for compute in "ib":
        assert {(compute, name) for name in cuda_exec._TYPED_EMIT[compute]} <= used


# --- The int32 extremes and the slice's graphs -------------------------------------------


@pytest.fixture(scope="module")
def typed_ops():
    previous = config.device()
    config.set_device("cpu")
    try:
        sink, leaves, r7 = benchmarks.typed_ops(JAX)
        return _run_both(sink, leaves, seed=1), r7
    finally:
        config.set_device(previous)


def test_typed_ops_twin_matches_jax_at_the_int32_extremes(typed_ops):
    values, r7 = typed_ops
    assert len(values) == 50  # 49 leaves and the sink
    for label, (want, got, kind) in values.items():
        assert kind == KIND_OF_DTYPE[want.dtype], label
        if label in r7:
            # R7: w ** -3 is 0 on the plain path; w ** 2 is 49 or wraps to
            # 2^25 + 1 (halves 512 and 1).
            assert set(np.unique(got)) <= {0.0, 1.0, 49.0, 512.0}, label
            continue
        np.testing.assert_array_equal(got, want.astype(np.float32), err_msg=label)
        assert np.all(got == np.asarray(got, np.float64)), label  # exact in float32


def test_typed_ops_meets_every_branch(typed_ops):
    values, _ = typed_ops
    want = {label: v[0] for label, v in values.items()}
    # -2^31 // -1 wraps, 7 // 0 = -2, 0 // 0 = -1, % 0 and % -1 give 0.
    floordiv = want["floordiv_hi"].astype(np.int64) * 65536 + want["floordiv_lo"]
    assert set(np.unique(floordiv)) == {-2**31, -2, -7}
    assert set(np.unique(want["floordiv_zero"])) == {-1, -2, 0, 3}
    assert set(np.unique(want["mod"])) == {0}
    assert set(np.unique(want["neg"])) == {-2**31, -7} and set(np.unique(want["abs"])) == {-2**31, 7}
    # (2^24 + 1)^2 wraps to 2^25 + 1; 2^24 + 1 > 2^24 in int32 (equal in float32).
    square = want["square_hi"].astype(np.int64) * 65536 + want["square_lo"]
    assert set(np.unique(square)) == {2**25 + 1, 49}
    assert want["gt"].any() and not want["gt"].all() and want["isclose"].all()


@pytest.fixture(scope="module")
def breach():
    previous = config.device()
    config.set_device("cpu")
    try:
        loss, nodes = benchmarks.breach_count(JAX)
        leaves = {k: nodes[k] for k in ("overruns", "late", "tier")}
        leaves.update({f"cost{i}": c for i, c in enumerate(nodes["costs"])})
        severe = nodes["severe"]  # outside loss's graph: a graph of its own
        return _run_both(loss, leaves, seed=2), _run_both(severe, {}, seed=2)
    finally:
        config.set_device(previous)


def test_breach_count_twin_matches_jax(breach):
    values, severe = breach
    want, got, kind = severe["sink"]
    assert kind == "b" and want.dtype == np.bool_
    np.testing.assert_array_equal(got, want.astype(np.float32))
    for label, (want, got, kind) in values.items():
        assert kind == KIND_OF_DTYPE[want.dtype], label
        if kind == "f":
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-4 * scale, label
        else:
            np.testing.assert_array_equal(got, want.astype(np.float32), err_msg=label)
    assert values["overruns"][2] == "i" and values["tier"][2] == "i" and values["late"][2] == "b"
    assert values["sink"][2] == "f"


def test_breach_count_budgets_give_the_stated_probability():
    import scipy.stats

    costs = [scipy.stats.triang(0.3, loc=80 + 5 * i, scale=60) for i in range(6)]
    costs += [scipy.stats.lognorm(0.25, scale=100 + 10 * j) for j in range(4)]
    pmf = np.array([1.0])
    for cost, budget in zip(costs, benchmarks.BREACH_BUDGETS):
        p = cost.sf(budget)
        pmf = np.convolve(pmf, [1 - p, p])
    assert 0.05 <= pmf[3:].sum() <= 0.3
    assert abs(pmf[3:].sum() - 0.1693) < 5e-5


def test_severe_sink_mean_is_its_probability():
    """A bool sink's streamed mean is the share of samples where it holds."""
    _, nodes = benchmarks.breach_count()
    severe = nodes["severe"]
    st = streaming.estimate(severe, 1 << 14, block_size=1 << 12, random_state=3, quantiles=(0.5,))
    x = streaming.sample_streaming(severe, 1 << 14, block_size=1 << 12, random_state=3)
    assert x.dtype == np.bool_ and st["mean"] == pytest.approx(x.mean(), rel=1e-12)
    assert abs(st["mean"] - 0.1693) < 5 * np.sqrt(0.1693 * 0.8307 / (1 << 14))
    assert st["min"] == 0.0 and st["max"] == 1.0 and st["q0.5"] == 0.0


# --- supports, constants, text, and what fails as on the plain path ----------------------


def _supports_pair(jax_sink, extra=()):
    mapping = interop.from_reference(jax_sink)
    ids = {jax_sink._id, *extra}
    plan = tcompile.get_plan(mapping[jax_sink._id])
    return (
        pallas_exec.supports(jax_compile.Plan(jax_sink), frozenset(ids)),
        cuda_exec.supports(plan, frozenset(mapping[i]._id for i in ids)),
    )


def test_supports_equals_pallas_exec_on_the_typed_graphs():
    sink, leaves, _ = benchmarks.typed_ops(JAX)
    assert _supports_pair(sink) == (True, True)
    assert _supports_pair(sink, [leaves["gt"]._id, leaves["neg"]._id]) == (True, True)
    loss, nodes = benchmarks.breach_count(JAX)
    keep = [nodes[k]._id for k in ("overruns", "late", "tier")]
    assert _supports_pair(loss, keep) == (True, True)
    assert _supports_pair(nodes["severe"]) == (True, True)
    loss, nodes = benchmarks.breach_count_correlated(JAX)
    keep = [nodes[k]._id for k in ("overruns", "late", "tier")]
    assert _supports_pair(loss, keep) == (True, True)
    assert all(_supports_pair(_grid_graph(JAX, part)[0]) == (True, True)
               for part in range(GRID_GRAPHS))


def test_int32_constants_reach_the_parameter_block_bit_for_bit():
    x = Distribution("uniform")
    sink = (x > 0.5) * (2**24 + 1) + tg.Constant(-2**31) * (x <= 0.5) + tg.Constant(True) * 1
    tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
    assert 2**24 + 1 in tape.consts and -2**31 in tape.consts and True in tape.consts
    words = list(tape.const_block)[:len(tape.consts)]
    for value, word in zip(tape.consts, words):
        kind = cuda_exec.const_kind(value)
        if kind == "f":
            assert word == int(np.float32(value).view(np.uint32))
        else:
            assert word == int(value) & 0xFFFFFFFF  # two's complement, never through a float
    assert (2**24 + 1) & 0xFFFFFFFF in words and 2**31 in words
    assert tape.imm.dtype == torch.float64 and 2**24 + 1 in tape.imm.tolist()
    out = cuda_exec.run_tape(tape, torch.tensor([[0.75], [0.25]]))
    # Stored as float32: 2^24 + 1 + 1 rounds to 2^24 + 2, -2^31 + 1 to -2^31.
    assert out[0].tolist() == [2.0**24 + 2, -(2.0**31)]


def test_int_constants_read_only_as_floats_travel_as_float32():
    """A float graph's int constants (``1 - tax_rate``) are read as floats
    only: they travel as their float32 values and nothing converts them in
    the kernel; an int constant an int row reads stays an int."""
    x = Distribution("uniform")
    sink = (1 - x) + (x > 0.5) * 3 + tg.Constant(2**24 + 1) * x
    tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
    assert [c for c in tape.consts if not isinstance(c, float)] == [3]
    assert 2.0**24 in tape.consts  # 2^24 + 1 rounded to float32, as the kernel would
    dag = benchmarks.mixed_dag_20()
    text = cuda_exec.lower(tcompile.get_plan(dag), [dag._id]).source
    body = text[text.index("const int64_t r0"):]
    assert "__float_as_int(" not in body and "__int2float_rn(" not in body
    U = torch.rand(256, 1)
    np.testing.assert_array_equal(cuda_exec.run_tape(tape, U)[0].numpy(),
                                  tcompile.build_body(tcompile.get_plan(sink), {sink._id})(U)[sink._id].numpy())


def test_an_int_beyond_int32_raises_as_the_plain_path_does():
    sink = Distribution("norm") + tg.Constant(2**31)
    with pytest.raises(RuntimeError) as plain:
        sink.sample(16, random_state=0)
    plan = tcompile.get_plan(sink)
    with pytest.raises(type(plain.value)):
        cuda_exec.lower(plan, [sink._id])
    assert cuda_exec.supports(plan, {sink._id})  # as pallas_exec: the graph fails to trace


def test_generated_text_types_its_lines():
    _, leaves, _ = benchmarks.typed_ops()
    loss, nodes = benchmarks.breach_count()
    plan = tcompile.get_plan(loss)
    order = cuda_exec.keep_order(plan, {loss._id, nodes["overruns"]._id, nodes["late"]._id})
    text = cuda_exec.lower(plan, order).source
    assert "const int v" in text and "const bool v" in text and "const float v" in text
    assert "add_i32(" in text and "floor_divide_i32(" in text and "floor_mod_i32(" in text
    assert "__int2float_rn(" in text and "static_cast<int>(" in text
    assert "__float_as_int(k.v[" in text  # an int32 constant read from its word
    assert "store_group(out + 0 * n, r0, n, vec, __int2float_rn(" in text  # STORE is float32


def test_kinds_are_structure_and_constants_are_not():
    def key(sink):
        tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
        return _build.generated_key(tape.source, cuda_exec._HEADERS), tape

    x = Distribution("uniform")
    (a, ta), (b, tb) = key((x > 0.5) * 7 + 3), key((x > 0.25) * -9 + 2**30)
    assert a == b and ta.consts != tb.consts  # int constants of other values: one build
    assert key((x > 0.5) * 7.0 + 3)[0] != a  # a float constant: another kind, another text
    assert key((x > 0.5) * True + 3)[0] != a  # a bool constant


def test_a_bool_negated_raises_as_the_plain_path_does():
    jax_sink = -(JaxDistribution("uniform") > 0.5) + 1
    assert _supports_pair(jax_sink) == (True, True)
    sink = interop.from_reference(jax_sink)[jax_sink._id]
    with pytest.raises(RuntimeError) as plain:
        sink.sample(16, random_state=0)
    with pytest.raises(type(plain.value)):
        cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
    x = Distribution("uniform")
    difference = (x > 0.5) - (x > 0.2)
    with pytest.raises(RuntimeError, match="bool"):
        cuda_exec.lower(tcompile.get_plan(difference), [difference._id])


def test_noop_inside_the_graph_fails_as_the_plain_path_does():
    """pallas_exec.supports refuses a NoOp only as the sink.  Anywhere
    else ``supports`` agrees, and a row that reads the NoOp's missing value
    raises what the plain executor raises (TypeError)."""
    a, b = JaxDistribution("norm"), JaxDistribution("uniform")
    assert _supports_pair(jg.NoOp(a, b)) == (False, False)
    jax_sink = jg.Add(jg.NoOp(a, b), 1.0)
    assert _supports_pair(jax_sink) == (True, True)
    with pytest.raises(TypeError):
        jax_sink.sample(16, random_state=0)
    sink = interop.from_reference(jax_sink)[jax_sink._id]
    with pytest.raises(TypeError):
        sink.sample(16, random_state=0)
    with pytest.raises(TypeError):
        cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
    # Whatever reads the NoOp raises the plain executor's exception: a
    # float function of it, a distribution's parameter.
    for sink in (tg.Exp(tg.NoOp(Distribution("norm"))) + 1.0,
                 Distribution("norm", loc=tg.NoOp(Distribution("uniform"))) * 2.0):
        with pytest.raises(Exception) as plain:
            sink.sample(16, random_state=0)
        assert isinstance(plain.value, (TypeError, AttributeError))
        with pytest.raises(type(plain.value)):
            cuda_exec.lower(tcompile.get_plan(sink), [sink._id])


def test_isclose_of_integers_matches_jax():
    """C3: jnp.isclose compares ints as floats within its tolerances."""
    x = JaxDistribution("uniform")
    near = (x > 0.5) * (2**24 + 1) + (x <= 0.5) * 100
    jax_sink = jg.IsClose(near, 2**24) * 1 + jg.IsClose(near, 101) * 2 + jg.IsClose(x > 0.5, True) * 4
    out = _run_both(jax_sink, {})
    want, got, _ = out["sink"]
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert set(np.unique(want)) == {1 + 4, 0}
