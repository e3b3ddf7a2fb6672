"""The CUDA megakernel's plain twin, its tape, and what runs without a card.

On the CPU: Philox4x32-10's known-answer vectors, the bits-to-uniform
map, ``run_tape(lower(plan), U)`` against the plain executor on the same
``U`` (bitwise after casting both to float32), the four-word layout of
the stream, the generator of the per-graph kernel text (what it reads,
what it writes, its cache key), ``supports`` against
``pallas_exec.supports``, and the package's import hygiene.  The kernel
itself is held against the twin on the card by ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import pallas_exec
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.models import graph as jg
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu_torch import _build, config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks, graph as tg
from probabilit_tpu_torch.models.distributions import (
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
)
from probabilit_tpu_torch.ops import philox
from test_torch_cuda import GRAPHS  # the same graphs the card tests run
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "probabilit_tpu_torch"
CSRC = PKG / "csrc"


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)

# Random123's known-answer vectors for Philox4x32-10.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    (
        (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
    ),
]


@pytest.mark.parametrize("counter,key,expected", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, expected):
    assert tuple(int(w) for w in philox.philox4x32_10(counter, key)) == expected


def _philox_python(counter, key):
    """Philox4x32-10 in Python integers: no overflow to avoid."""
    c, (k0, k1) = list(counter), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
        k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
    return c


def test_philox_vectorised_matches_python_integers():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(4, 64), dtype=np.uint64).astype(np.int64)
    words[:, :4] = 2**32 - 1  # the products that overflow int64 when done naively
    key = (0xDEADBEEF, 0xFFFFFFFF)
    got = philox.philox4x32_10([torch.from_numpy(w) for w in words], key)
    for j in range(words.shape[1]):
        ref = _philox_python([int(w) for w in words[:, j]], key)
        assert [int(g[j]) for g in got] == ref


def test_bits_to_open_unit_extremes():
    bits = torch.tensor([0, 0x1FF, 1 << 9, 0x80000000, 0xFFFFFFFF], dtype=torch.int64)
    u = philox.bits_to_open_unit(bits)
    assert u.dtype == torch.float32
    # All-ones bits give 1 - 2^-23: the upper clamp only guards the grid.
    expected = [2.0**-24, 2.0**-24, 2.0**-23, 0.5, 1.0 - 2.0**-23]
    np.testing.assert_array_equal(u.numpy(), np.array(expected, np.float32))


def test_philox_uniforms_depend_on_the_seed_and_not_on_n():
    words = cuda_exec.seed_words(2**40 + 17)
    assert words == (17, 256)
    a = cuda_exec.philox_uniforms(words, 1000, 3)
    b = cuda_exec.philox_uniforms(words, 400, 3)
    torch.testing.assert_close(a[:400], b, rtol=0, atol=0)
    # ... nor on where a run starts, aligned to a group of four or not.
    for start, n in ((7, 10), (8, 9), (399, 5), (1, 2)):
        part = cuda_exec.philox_uniforms(words, n, 3, start=start)
        torch.testing.assert_close(part, a[start:start + n], rtol=0, atol=0)
    c = cuda_exec.philox_uniforms(cuda_exec.seed_words(18), 400, 3)
    assert not torch.equal(b, c)
    assert float(a.min()) >= 2.0**-24 and float(a.max()) <= 1.0 - 2.0**-24
    assert abs(float(a.mean()) - 0.5) < 0.03


def test_philox_uniforms_are_the_four_words_of_each_group():
    key, start, n, columns = (0x9ABCDEF0, 7), 2**34 + 5, 11, [0, 6]  # g > 2^32: both words
    got = cuda_exec.philox_uniforms(key, n, 7, columns=columns, start=start)
    assert got.shape == (n, 2) and got.dtype == torch.float32
    for row in range(n):
        i = start + row
        g = i >> 2
        for j, c in enumerate(columns):
            word = _philox_python((g & 0xFFFFFFFF, g >> 32, c, 0), key)[i & 3]
            want = philox.bits_to_open_unit(torch.tensor([word], dtype=torch.int64))
            assert got[row, j] == want[0], (row, c)


CORRELATED = {"mixed_correlated_50": benchmarks.mixed_correlated_50}


def _tape_and_ab(name, words, n_for_ab=4096):
    sink = {**GRAPHS, **CORRELATED}[name]()
    plan = tcompile.get_plan(sink)
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, _keep(plan, 4)))
    ab = cuda_exec.recolor_transform(plan, words, n_for_ab, device="cpu") if plan.corr_vars else None
    return plan, tape, ab


@pytest.mark.parametrize("start,n", [(1, 5), (6, 3), (7, 1030), (4, 8), (1023, 2)])
@pytest.mark.parametrize("name", ["mixed_dag_20", "mixed_correlated_50"])
def test_run_reference_at_any_start_equals_rows_of_a_longer_run(name, start, n):
    words = (21, 22)
    _, tape, ab = _tape_and_ab(name, words)
    whole = cuda_exec.run_reference(tape, words, start + n, ab)
    part = cuda_exec.run_reference(tape, words, n, ab, start=start)
    torch.testing.assert_close(part, whole[:, start:], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["mixed_dag_20", "mixed_correlated_50", "height_model"])
def test_value_program_equals_the_tape_bitwise(name):
    words = (31, 32)
    plan, tape, ab = _tape_and_ab(name, words)
    U = cuda_exec.philox_uniforms(words, 4096, plan.d)
    assert len(tape.program) == tape.n_instr
    dsts = [row[1] for row in tape.program
            if cuda_exec.OPCODES[row[0]] not in ("STORE", "SCORE")]
    assert dsts == sorted(set(dsts))  # one value per row, never written twice
    torch.testing.assert_close(
        cuda_exec.run_program(tape, U, ab), cuda_exec.run_tape(tape, U, ab), rtol=0, atol=0
    )


def _keep(plan, width):
    """The sink and up to ``width - 1`` of the nodes just before it."""
    others = [node._id for node in plan.topo if node is not plan.sink]
    return frozenset(others[len(others) - (width - 1):] + [plan.sink._id])


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("keep", ["sink", "wide"])
def test_tape_equals_plain_executor_bitwise(name, keep):
    sink = GRAPHS[name]()
    plan = tcompile.get_plan(sink)
    keep_ids = _keep(plan, 16 if keep == "wide" else 1)
    assert cuda_exec.supports(plan, keep_ids)
    order = cuda_exec.keep_order(plan, keep_ids)
    assert order[-1] == sink._id
    tape = cuda_exec.lower(plan, order)
    assert tape.n_slots <= cuda_exec.MAX_SLOTS and tape.code.dtype == torch.int32
    U = cuda_exec.philox_uniforms(cuda_exec.seed_words(11), 4096, plan.d)
    ref = tcompile.build_body(plan, keep_ids)(U)
    got = cuda_exec.run_tape(tape, U)
    for k, nid in enumerate(order):
        torch.testing.assert_close(got[k], ref[nid].to(torch.float32), rtol=0, atol=0)


def test_slots_are_reused_by_liveness():
    sink = benchmarks.mixed_dag_20()
    plan = tcompile.get_plan(sink)
    tape = cuda_exec.lower(plan, [sink._id])
    assert tape.n_instr == 63 and tape.n_slots <= 12
    # A chain far longer than the slot cap still fits: values die young.
    x = Distribution("norm")
    for _ in range(300):
        x = tg.Exp(x * 0.001)
    tape = cuda_exec.lower(tcompile.get_plan(x), [x._id])
    assert tape.n_instr > cuda_exec.MAX_SLOTS and tape.n_slots <= 3


def test_run_on_a_cpu_tape_is_the_twin_and_counts_no_launch():
    sink = benchmarks.mixed_dag_20()
    plan = tcompile.get_plan(sink)
    tape = cuda_exec.lower(plan, [sink._id])
    launches = cuda_exec.LAUNCHES
    out, nonfinite = cuda_exec.run(tape, (5, 6), 2048)
    assert cuda_exec.LAUNCHES == launches
    torch.testing.assert_close(out, cuda_exec.run_reference(tape, (5, 6), 2048), rtol=0, atol=0)
    assert out.shape == (1, 2048) and int(nonfinite) == 0
    bad = tg.Log(Distribution("norm"))
    bad_plan = tcompile.get_plan(bad)
    _, nonfinite = cuda_exec.run(cuda_exec.lower(bad_plan, [bad._id]), (5, 6), 2048)
    assert int(nonfinite) == 1


def _supports_pair(jax_sink, extra=()):
    """(pallas_exec.supports, cuda_exec.supports) on one graph."""
    mapping = interop.from_reference(jax_sink)
    ids = {jax_sink._id, *extra}
    port_ids = {mapping[i]._id if i in mapping else i for i in ids}
    plan = tcompile.get_plan(mapping[jax_sink._id])
    return (
        pallas_exec.supports(jax_compile.Plan(jax_sink), frozenset(ids)),
        cuda_exec.supports(plan, frozenset(port_ids)),
    )


def _jax_wide():
    total = JaxDistribution("norm")
    keep = [total]
    for _ in range(17):
        total = total + JaxDistribution("norm")
        keep.append(total)
    return total, [n._id for n in keep]


def test_supports_agrees_with_pallas_exec():
    a, b = JaxDistribution("norm"), JaxDistribution("uniform")
    arith = a * jg.Exp(b) + jg.Constant(2)
    cases = [
        (jax_benchmarks.mixed_dag_20(), ()),
        (jax_benchmarks.height_model(), ()),
        (arith, ()),
        (arith, (a._id, b._id)),
        (arith, (10**9,)),  # a foreign id
        (jg.NoOp(a, b), ()),
        _jax_wide(),
        (JaxDistribution("triang", c=0.5, loc=a, scale=jg.Abs(b) + 1) * 2, ()),
    ]
    for sink, extra in cases:
        ref, got = _supports_pair(sink, extra)
        assert ref == got, (sink, extra)
    # The sink must be kept.
    plan = tcompile.get_plan(benchmarks.mixed_dag_20())
    assert not cuda_exec.supports(plan, frozenset({plan.topo[0]._id}))


def test_supports_refuses_what_the_port_lacks():
    a, b = JaxDistribution("norm"), JaxDistribution("norm")
    corr_sink = (a + b).correlate(a, b, corr_mat=np.eye(2))
    assert _supports_pair(corr_sink) == (True, True)  # ported since: ROADMAP A6
    poisson = JaxDistribution("poisson", mu=3.5) + 0
    assert _supports_pair(poisson) == (True, True)  # the table branch, ported since: B3
    hypergeom = JaxDistribution("hypergeom", 30, 25, 20) * 2
    assert _supports_pair(hypergeom) == (True, True)  # ROADMAP B3
    c = JaxDistribution("poisson", mu=3.5)
    corr_poisson = (a + c).correlate(a, c, corr_mat=np.eye(2))
    assert _supports_pair(corr_poisson) == (True, True)
    # Integer-typed values on the tape, ported since: ROADMAP B4.
    integer = JaxDistribution("norm") + jg.Constant(3) * jg.Constant(5)
    assert _supports_pair(integer) == (True, True)


@pytest.mark.parametrize(
    "build",
    [
        lambda g, x: (g.Constant(7) // g.Constant(2)) + x,
        lambda g, x: (g.Constant(3) * g.Constant(5)) + x,
        lambda g, x: g.Add(x > 0.25, x > 0.75),
        lambda g, x: g.Power(g.Constant(2), g.Constant(3)) + x,
    ],
    ids=["floordiv", "multiply", "bool_add", "power"],
)
def test_supports_refuses_integer_and_boolean_arithmetic(build):
    """Refused until the tape carried int32 and bool values (ROADMAP B4):
    now each graph is supported, as by pallas_exec, and the twin gives the
    JAX package's values cast to float32, exactly.  (The power's exponent
    is no longer -1: jnp's negative integer powers are R7.  A standard
    uniform's ppf is exact in both packages.)"""
    jax_sink = build(jg, JaxDistribution("uniform"))
    assert _supports_pair(jax_sink) == (True, True)
    sink = interop.from_reference(jax_sink)[jax_sink._id]
    plan = tcompile.get_plan(sink)
    U = np.random.default_rng(5).integers(1, 2**23, (512, plan.d)) / 2**23
    want = np.asarray(jax_sink.sample_from_quantiles(U.astype(np.float32)))
    got = cuda_exec.run_tape(cuda_exec.lower(plan, [sink._id]), torch.from_numpy(U).float())
    np.testing.assert_array_equal(got[0].numpy(), want.astype(np.float32))


def test_supports_accepts_float_valued_ops_of_integers():
    x = Distribution("norm")
    sink = tg.Divide(tg.Constant(7), tg.Constant(2)) + tg.Exp(tg.Constant(1)) + tg.All(x > 0, x < 1)
    plan = tcompile.get_plan(sink)
    assert cuda_exec.supports(plan, frozenset({sink._id}))
    U = cuda_exec.philox_uniforms((1, 2), 256, plan.d)
    torch.testing.assert_close(
        cuda_exec.run_tape(cuda_exec.lower(plan, [sink._id]), U)[0],
        tcompile.build_body(plan, {sink._id})(U)[sink._id].float(), rtol=0, atol=0,
    )


def _hand_tape(rows, n_corr=0):
    """A tape around hand-written value-numbered rows (the generator reads
    ``program``, ``n_corr``, the kept rows and the number of constants)."""
    op = {name: i for i, name in enumerate(cuda_exec.OPCODES)}
    program = tuple((op[r[0]], *r[1:], *[-1] * (6 - len(r))) for r in rows)
    consts = tuple(0.5 for r in rows if r[0] == "LOADK")
    keep = tuple(r[1] for r in rows if r[0] == "STORE")
    code = torch.tensor(program, dtype=torch.int32)
    return cuda_exec.Tape(code, torch.zeros(len(rows)), len(rows), 2, keep, n_corr, program, consts)


def _loop_body(text):
    """The generated lines: from the group loop to the end of the kernel."""
    return text[text.index("const int64_t r0"):text.index("if (bad) atomicOr")]


@pytest.mark.parametrize("name", cuda_exec.OPCODES)
def test_every_opcode_has_an_emitter(name):
    assert set(cuda_exec._EMIT) == set(cuda_exec.OPCODES)
    # Values 0, 1: draws; 2, 3: constants 0 and 1 of the parameter block.
    head = [("DRAW", 0, 0), ("DRAW", 1, 4), ("LOADK", 2), ("LOADK", 3),
            ("SCORE", 0, 0), ("SCORE", 1, 1)]
    if name == "RECOLOR":
        body = _loop_body(_hand_tape(head + [("RECOLOR", 4, 1), ("STORE", 0, 4)], 2).source)
        assert "const float4 a4_0 = s_a4[1];" in body  # row 1 of A, padded to 4 floats
        assert "const float v4_2 = s_b[1] + a4_0.x * z0_2 + a4_0.y * z1_2;" in body
        return
    if name in ("DRAW", "LOADK", "STORE", "SCORE"):
        body = _loop_body(_hand_tape(head + [("ADD", 4, 1, 3), ("STORE", 0, 4), ("STORE", 1, 2)], 2).source)
        assert "const uint4 w1 = philox_group(g, 4u, k0, k1);" in body
        assert "const float v1_3 = bits_to_open_unit(w1.w);" in body
        assert "const float z1_0 = ndtri_fast(v1_0);" in body
        assert "const float v4_1 = v1_1 + k.v[1];" in body  # a constant is an operand
        assert "v2_" not in body and "v3_" not in body  # ... and never a line
        assert "store_group(out + 0 * n, r0, n, vec, v4_0, v4_1, v4_2, v4_3, bad);" in body
        assert "store_group(out + 1 * n, r0, n, vec, k.v[0], k.v[0], k.v[0], k.v[0], bad);" in body
        return
    template = cuda_exec._EMIT[name]
    if name in cuda_exec.NEWTON_OPS:
        # q goes to the block's shared memory, the block solves it, and the
        # row reads its value back; the shapes are constants of its row.
        family = cuda_exec.NEWTON_OPS[name]
        shapes = (2, 3)[: cuda_exec._n_shapes(family)]
        text = _hand_tape([("DRAW", 0, 0), ("LOADK", 2), ("LOADK", 3), (name, 4, 0, *shapes),
                           ("STORE", 0, 4)]).source
        solve = ("newton_ops::solve<kThreads, kGroups, kFamilies>(s_newton, s_rows, &s_next, 1,\n"
                 "                                                    live_groups);")
        before, after = text.split(solve)
        for lane in range(cuda_exec.LANES):
            slot = f"{lane * cuda_exec._THREADS} + sub * {cuda_exec._TILE}"
            assert f"s_newton[{slot} + threadIdx.x] = v0_{lane};" in before
            assert f"const float v4_{lane} = {template.format(slot=slot)};" in after
        args = ", ".join([f"k.v[{i}]" for i in range(len(shapes))] + ["0.0f"] * (2 - len(shapes)))
        family_id = cuda_exec._NEWTON_FAMILY_ID[family]
        assert f"s_rows[0] = newton_ops::make_row<kFamilies>(newton_ops::{family_id}, {args});" in text
        assert f"constexpr unsigned kFamilies = (1u << newton_ops::{family_id});" in text
        return
    if name.startswith("TABLE_"):
        # q, then two literals: the table's offset and its boundaries.
        body = _loop_body(_hand_tape(head + [(name, 4, 1, 8, 5), ("STORE", 0, 4)]).source)
        for lane in range(cuda_exec.LANES):
            text = template.format(a=f"v1_{lane}", b=8, c=5)
            assert f"const float v4_{lane} = {text};" in body
        assert re.match(r"table_\w+<5>\(s_tab \+ 8, v1_0\)$", template.format(a="v1_0", b=8, c=5))
        return
    arity = sum(f"{{{f}}}" in template for f in "abcd")
    assert arity >= 1 and "{" not in template.format(a="", b="", c="", d="")
    tape = _hand_tape(head + [(name, 4, *(0, 2, 1, 3)[:arity]), ("STORE", 0, 4)])
    body = _loop_body(tape.source)
    # On float operands a comparison is a bool, AND and OR read each
    # operand as a bool, every other row is a float.
    kind = tape.kinds[len(head)]
    assert kind == ("b" if name in ("AND", "OR", "ISCLOSE", *cuda_exec._COMPARISONS) else "f")
    for lane in range(cuda_exec.LANES):
        operands = dict(zip("abcd", (f"v0_{lane}", "k.v[0]", f"v1_{lane}", "k.v[1]")))
        if name in ("AND", "OR"):
            operands = {f: f"({text} != 0.0f)" for f, text in operands.items()}
        ctype = {"b": "bool", "f": "float"}[kind]
        assert f"const {ctype} v4_{lane} = {template.format(**operands)};" in body


def test_opcodes_and_caps_match_the_kernel_source():
    headers = {name: (CSRC / name).read_text() for name in cuda_exec._HEADERS}
    sink = benchmarks.mixed_correlated_50()
    text = cuda_exec.lowered(tcompile.get_plan(sink), [sink._id]).source
    for name in headers:
        assert f'#include "{name}"' in text
    assert f"kThreads = {cuda_exec._THREADS};" in text
    assert f"kMaxCorr = {cuda_exec.MAX_CORR_K};" in (CSRC / "corr_stats.cu").read_text()
    assert not (CSRC / "graph_megakernel.cu").exists()  # no interpreter beside the generator
    # Every function an emitter calls is CUDA's float32 libm or defined,
    # by hand, in one of the two headers.
    libm = {"powf", "atan2f", "fabsf", "logf", "expf", "floorf", "ceilf", "sqrtf", "log10f",
            "sinf", "cosf", "tanf", "asinf", "acosf", "atanf", "sinhf", "coshf", "tanhf",
            "asinhf", "acoshf", "atanhf", "log1pf", "expm1f"}
    defined = set(re.findall(r"__device__ __forceinline__ \w+ (\w+)\(", "".join(headers.values())))
    templates = [*cuda_exec._EMIT.values(), *cuda_exec._TYPED_EMIT["i"].values(),
                 *cuda_exec._TYPED_EMIT["b"].values()]
    called = set(re.findall(r"(\w+)\(", " ".join(templates)))
    assert called <= libm | defined, called - libm - defined
    assert {"philox_group", "store_group", "ndtri_fast", "floor_divide", "ppf_triang"} <= defined
    # The closed forms compute on fast_math.cuh, which every generated text
    # includes before them.
    assert '#include "fast_math.cuh"' in headers["ppf_ops.cuh"]
    assert {"log_fast", "log1p_fast", "exp_fast", "pow_fast", "tan_or_cot"} <= defined
    # A 4 KB parameter space holds the constants beside the other arguments.
    assert 4 * cuda_exec.MAX_CONSTS + 64 <= 4096


def test_many_ops_runs_every_transform_opcode():
    # The card tests hold the generated kernel to its twin on this graph.
    sink = GRAPHS["many_ops"]()
    tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
    used = {cuda_exec.OPCODES[row[0]] for row in tape.program}
    assert set(cuda_exec._TRANSFORM_OPS.values()) <= used


def _fresh(name):
    """(plan, sink-only tape) of a newly built graph: new node ids each time."""
    sink = {**GRAPHS, **CORRELATED}[name]()
    plan = tcompile.get_plan(sink)
    return plan, cuda_exec.lower(plan, [sink._id])


@pytest.mark.parametrize("name", ["mixed_dag_20", "mixed_correlated_50", "many_ops"])
def test_generated_text_is_deterministic_and_straight_line(name):
    plan, tape = _fresh(name)
    text = cuda_exec.generate(tape)
    assert text == tape.source == cuda_exec.generate(_fresh(name)[1])
    kernel = text[text.index("__global__"):text.index("}  // namespace")]
    assert "switch" not in kernel and "case " not in kernel
    # No per-thread array: the only arrays are the shared copy of (A, b),
    # and the generated lines subscript with integer literals alone.
    assert len(re.findall(r"__shared__ \w+ \w+\[", kernel)) == (2 if plan.corr_vars else 0)
    assert re.findall(r"^\s*(?:const )?(?:float|int|uint32_t)\s+\w+\[", kernel, re.M) == []
    body = _loop_body(text)
    assert set(re.findall(r"\[([^\]]*)\]", body)) <= {str(i) for i in range(1024)}
    lines = [line.strip() for line in body.splitlines()[1:] if line.strip() and line.strip() != "}"]
    assert all(re.match(r"(const (float|float4|uint4|int|bool) \w+ = .*;|store_group\(.*\);)$", line)
               for line in lines), [l for l in lines if not l.startswith(("const", "store"))]
    # K, the kept rows and the constants are the text's compile-time shape.
    assert f"kCorr = {len(plan.corr_vars)};" in text and f"kKeep = {tape.n_keep};" in text
    assert f"kConsts = {len(tape.consts)};" in text
    assert body.count("store_group(") == tape.n_keep == 1
    assert body.count("philox_group(") == plan.d  # one call per column and group of four
    # Nothing of the graph's data is printed: the only float literals are
    # the emitters' own 0.0f.
    assert set(re.findall(r"\d+\.\d+f?", body)) <= {"0.0f"}


def _priced(loc, scale, wiring="add"):
    x = Distribution("norm", loc=loc, scale=scale)
    y = Distribution("expon", scale=scale)
    return tg.Exp(x * 0.5) + y if wiring == "add" else tg.Exp(x * 0.5) * y


def test_cache_key_is_the_structure_not_the_constants():
    def key(sink, keep=()):
        plan = tcompile.get_plan(sink)
        order = cuda_exec.keep_order(plan, frozenset({sink._id, *keep}))
        tape = cuda_exec.lower(plan, order)
        return _build.generated_key(tape.source, cuda_exec._HEADERS), tape

    (a, tape_a), (b, tape_b) = key(_priced(1.0, 2.0)), key(_priced(-3.5, 0.25))
    assert a == b and tape_a.source == tape_b.source and tape_a.consts != tape_b.consts
    assert key(_priced(1.0, 2.0, wiring="mul"))[0] != a  # another opcode
    assert key(Distribution("norm", loc=1.0, scale=2.0) + _priced(1.0, 2.0))[0] != a  # another column
    kept = _priced(1.0, 2.0)
    assert key(kept, keep=[kept.parents[0]._id])[0] != a  # another kept row
    # Tables: their values travel in Tape.tables, their offsets and sizes
    # are structure.
    rng = np.random.default_rng(3)
    (c, tape_c), (d, tape_d) = (
        key(EmpiricalDistribution(rng.normal(size=64)) * DiscreteDistribution(
            np.arange(8.0), rng.dirichlet(np.ones(8))) + Distribution("poisson", mu=30.0))
        for _ in range(2))
    assert c == d and tape_c.consts == tape_d.consts
    assert not torch.equal(tape_c.tables, tape_d.tables)
    assert key(EmpiricalDistribution(rng.normal(size=65)) * DiscreteDistribution(
        np.arange(8.0)) + Distribution("poisson", mu=30.0))[0] != c  # another table size
    # The key follows the headers' bytes and the compiler flags too.
    assert _build.generated_key(tape_a.source, cuda_exec._HEADERS[:1]) != a


def test_lowering_is_cached_on_the_plan_per_keep_order(monkeypatch):
    sink = benchmarks.mixed_dag_20()
    plan = tcompile.get_plan(sink)
    calls = []
    real = cuda_exec.lower
    monkeypatch.setattr(cuda_exec, "lower", lambda *a: calls.append(a) or real(*a))
    assert cuda_exec.supports(plan, frozenset({sink._id}))
    tape = cuda_exec.lowered(plan, [sink._id])
    assert cuda_exec.lowered(plan, [sink._id]) is tape and len(calls) == 1
    assert cuda_exec.lowered(plan, [sink._id], "meta") is cuda_exec.lowered(plan, [sink._id], "meta")
    other = cuda_exec.lowered(plan, [plan.topo[-2]._id, sink._id])
    assert other is not tape and len(calls) == 2
    assert tcompile.get_plan(benchmarks.mixed_dag_20()) is not plan  # a new graph, a new cache


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "probabilit_tpu"), (path, name)


def test_import_calls_no_compiler():
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a compiler ran at import')\n"
        "subprocess.Popen.__init__ = refuse\n"
        "import probabilit_tpu_torch, probabilit_tpu_torch.interop\n"
        "from probabilit_tpu_torch import _build\n"
        "from probabilit_tpu_torch.engine import cuda_exec, sampler\n"
        "assert _build._LIBS == {}\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_run_on_a_non_cpu_tape_never_falls_back(monkeypatch, tmp_path):
    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(cuda_exec, "run_reference", forbidden)
    monkeypatch.setattr(cuda_exec, "run_tape", forbidden)
    sink = benchmarks.mixed_dag_20()
    tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id]).to("meta")
    with pytest.raises(RuntimeError, match="executor='cuda'"):
        cuda_exec.run(tape, (0, 0), 1024)
    # A build that fails raises too: past the environment check, without a
    # compiler and with one that exits non-zero.
    monkeypatch.setattr(cuda_exec, "environment_issue", lambda device=None: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    launches = cuda_exec.LAUNCHES

    def no_compiler():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH).")

    monkeypatch.setattr(_build, "nvcc_path", no_compiler)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_exec.run(tape, (0, 0), 1024)
    monkeypatch.setattr(_build, "nvcc_path", lambda: Path("/bin/false"))
    with pytest.raises(RuntimeError, match="nvcc failed with exit code 1"):
        cuda_exec.run(tape, (0, 0), 1024)
    assert cuda_exec.LAUNCHES == launches and _build._LIBS == {}
    written = sorted(p.name for p in tmp_path.iterdir())
    key = _build.generated_key(tape.source, cuda_exec._HEADERS)
    assert written == [f"graph_megakernel-{key}.cu"]  # the text stays for reading; no library
    assert (tmp_path / written[0]).read_text() == tape.source
