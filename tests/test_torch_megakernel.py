"""The CUDA megakernel's plain twin, its tape, and what runs without a card.

On the CPU: Philox4x32-10's known-answer vectors, the bits-to-uniform
map, ``run_tape(lower(plan), U)`` against the plain executor on the same
``U`` (bitwise after casting both to float32), ``supports`` against
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
from probabilit_tpu_torch import interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks, graph as tg
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.ops import philox
from test_torch_cuda import GRAPHS  # the same graphs the card tests run

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "probabilit_tpu_torch"
KERNEL_SRC = PKG / "csrc" / "graph_megakernel.cu"

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
    c = cuda_exec.philox_uniforms(cuda_exec.seed_words(18), 400, 3)
    assert not torch.equal(b, c)
    assert float(a.min()) >= 2.0**-24 and float(a.max()) <= 1.0 - 2.0**-24
    assert abs(float(a.mean()) - 0.5) < 0.03


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
    assert tape.n_instr == 55 and tape.n_slots <= 12
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
    assert _supports_pair(corr_sink) == (True, False)  # the next slice, ROADMAP A6
    gamma = JaxDistribution("gamma", a=2.0) + 0
    assert _supports_pair(gamma) == (True, False)  # ROADMAP A8


@pytest.mark.parametrize(
    "build",
    [
        lambda x: (tg.Constant(7) // tg.Constant(2)) + x,
        lambda x: (tg.Constant(3) * tg.Constant(5)) + x,
        lambda x: tg.Add(x > 0, x > 1),
        lambda x: tg.Power(tg.Constant(2), tg.Constant(-1)) + x,
    ],
    ids=["floordiv", "multiply", "bool_add", "power"],
)
def test_supports_refuses_integer_and_boolean_arithmetic(build):
    sink = build(Distribution("norm"))
    plan = tcompile.get_plan(sink)
    assert not cuda_exec.supports(plan, frozenset({sink._id}))
    with pytest.raises(ValueError, match="not supported"):
        cuda_exec.lower(plan, [sink._id])


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


def test_opcodes_and_caps_match_the_kernel_source():
    src = KERNEL_SRC.read_text()
    enum = re.search(r"enum Op : int \{(.*?)\};", src, re.S).group(1)
    names = [n.strip()[3:] for n in enum.split(",") if n.strip()]
    assert names == cuda_exec.OPCODES
    assert f"kMaxSlots = {cuda_exec.MAX_SLOTS};" in src
    assert f"kMaxInstr = {cuda_exec.MAX_INSTR};" in src


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


def test_run_on_a_non_cpu_tape_never_falls_back(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(cuda_exec, "run_reference", forbidden)
    sink = benchmarks.mixed_dag_20()
    tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id]).to("meta")
    with pytest.raises(RuntimeError, match="executor='cuda'"):
        cuda_exec.run(tape, (0, 0), 1024)
