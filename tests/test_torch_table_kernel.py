"""K1's table rows (``TABLE_CDF``, ``TABLE_DISCRETE``, ``TABLE_INTERP``) on the CPU.

The twin's rows (``cuda_exec._table_row``: ``torch.searchsorted`` on the
float32 tables ``cdf_layout``/``discrete_layout``/``interp_layout`` lay
out) against the TPU kernel's select trees, ``pallas_exec``'s
``_kernel_table_ppf``, ``_kernel_discrete`` and ``_kernel_interp``, on
seeded quantiles and on quantiles equal to the boundaries: ports of
``TestKernelTableHelpers`` and ``TestSelectTreeLargeTables``
(``tests/test_pallas_exec.py:192-322``).  All bitwise: counts are exact,
and the interval arithmetic is one rounding per operation in both (the
JAX helpers run eagerly, op by op).  A numpy transcription of the CUDA
search (``csrc/table_ops.cuh``'s ``Search``) is held to
``torch.searchsorted`` on the same tables, since the CUDA code runs only
on the card.  Then the eligibility (``supports`` against
``pallas_exec.supports``), the lowering, the generated text, and the twin
against the plain executor on ``benchmarks.table_risk()``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu import config as jax_config
from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import pallas_exec
from probabilit_tpu.models.distributions import CumulativeDistribution as JaxCumulative
from probabilit_tpu.models.distributions import DiscreteDistribution as JaxDiscrete
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu.models.distributions import EmpiricalDistribution as JaxEmpirical
from probabilit_tpu_torch import _build, config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models import graph as tg
from probabilit_tpu_torch.models.distributions import (
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
)
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


REL_TOL = 1e-4


def _row(name, nb, data, q):
    return cuda_exec._table_row(name, torch.from_numpy(data), 0, nb, torch.from_numpy(q)).numpy()


def _search(bounds, q, strict):
    """``Search<NB, kStrict>::count`` of csrc/table_ops.cuh, step for step:
    the branch-free lower bound, ``base`` moving by the left half while the
    boundary it reads is below q (or at or below it)."""
    def below(v):
        return v < q if strict else v <= q

    base = np.zeros(q.shape, np.int64)
    n = len(bounds)
    if n == 0:
        return base
    while n > 1:
        half = n // 2
        base = np.where(below(bounds[base + half]), base + half, base)
        n -= half
    return base + below(bounds[base])


def _cdf_quantiles(table, seed, n):
    q = np.random.default_rng(seed).uniform(2.0**-24, 1 - 2.0**-24, size=n).astype(np.float32)
    q[: len(table)] = table  # exact boundary hits: the strict side
    return q


@pytest.mark.parametrize("mu,seed,n", [(3, 3, 4096), (2000, 9, 8192)])
def test_table_cdf_matches_the_select_tree(mu, seed, n):
    node = JaxDistribution("poisson", mu=mu)
    table, loc = pallas_exec._trimmed_cdf_table(node)
    if mu == 2000:
        assert 256 < len(table) <= 512 and loc > 0 and float(table[0]) >= 2.0**-24
    q = _cdf_quantiles(table, seed, n)
    ref = np.asarray(pallas_exec._kernel_table_ppf(jnp.asarray(q), table, loc))
    nb, data = cuda_exec.cdf_layout(table)
    got = _row("TABLE_CDF", nb, data, q) + np.float32(loc)
    np.testing.assert_array_equal(got, ref)
    count = np.minimum(np.searchsorted(table, q, side="left"), len(table) - 1)
    np.testing.assert_array_equal(_search(table[:-1], q, strict=True), count)


@pytest.mark.parametrize("size,seed", [(9, 2), (512, 10)])
def test_table_discrete_matches_the_select_tree(size, seed):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(size))
    values = rng.integers(-50, 50, size=size).astype(np.float64) if size == 9 else rng.normal(size=size)
    cumulative = np.cumsum(p)
    q = rng.uniform(0, 1, size=8192).astype(np.float32)
    q[:size] = cumulative.astype(np.float32)  # exact threshold hits: the non-strict side
    ref = np.asarray(pallas_exec._kernel_discrete(jnp.asarray(q), cumulative, values))
    nb, data = cuda_exec.discrete_layout(cumulative, values)
    np.testing.assert_array_equal(_row("TABLE_DISCRETE", nb, data, q), ref)
    idx = np.minimum(np.searchsorted(cumulative.astype(np.float32), q, side="right"), size - 1)
    np.testing.assert_array_equal(_search(cumulative.astype(np.float32)[:-1], q, False), idx)


@pytest.mark.parametrize("size,seed,lo,hi", [(17, 1, -0.1, 1.1), (512, 11, -0.05, 1.05)])
def test_table_interp_matches_the_select_tree(size, seed, lo, hi):
    rng = np.random.default_rng(seed)
    xp = np.sort(rng.uniform(0, 1, size=size))
    fp = rng.normal(size=size)
    q = rng.uniform(lo, hi, size=8192).astype(np.float32)
    q[:size] = xp.astype(np.float32)  # exact knot hits
    ref = np.asarray(pallas_exec._kernel_interp(jnp.asarray(q), xp, fp))
    nb, data = cuda_exec.interp_layout(xp, fp)
    np.testing.assert_array_equal(_row("TABLE_INTERP", nb, data, q), ref)
    np.testing.assert_array_equal(
        _search(xp[:-1].astype(np.float32), q, False),
        np.searchsorted(xp[:-1].astype(np.float32), q, side="right"))


def test_interp_duplicate_knots():
    xp = np.array([0.0, 0.25, 0.25, 1.0])
    fp = np.array([0.0, 1.0, 5.0, 6.0])
    q = np.array([0.1, 0.25, 0.26, 0.9999, 1.0, -1.0, 2.0], np.float32)
    ref = np.asarray(pallas_exec._kernel_interp(jnp.asarray(q), xp, fp))
    nb, data = cuda_exec.interp_layout(xp, fp)
    got = _row("TABLE_INTERP", nb, data, q)
    np.testing.assert_array_equal(got, ref)
    assert got[1] == 5.0  # the right-hand value at the jump


def test_single_entry_tables():
    q = np.array([0.2, 0.8], np.float32)
    ref = np.asarray(pallas_exec._kernel_discrete(jnp.asarray(q), np.array([1.0]), [7.0]))
    nb, data = cuda_exec.discrete_layout(np.array([1.0]), [7.0])
    assert nb == 0 and len(data) == 4
    np.testing.assert_array_equal(_row("TABLE_DISCRETE", nb, data, q), ref)
    np.testing.assert_array_equal(ref, [7.0, 7.0])
    ref = np.asarray(pallas_exec._kernel_table_ppf(jnp.asarray(q), np.array([1.0]), 3.0))
    nb, data = cuda_exec.cdf_layout(np.array([1.0], np.float32))
    np.testing.assert_array_equal(_row("TABLE_CDF", nb, data, q) + 3.0, ref)
    nb, data = cuda_exec.interp_layout([0.0], [4.5])  # a one-point Empirical
    np.testing.assert_array_equal(_row("TABLE_INTERP", nb, data, q), [4.5, 4.5])
    np.testing.assert_array_equal(_search(np.zeros(0, np.float32), q, True), [0, 0])


def test_nan_quantiles_give_nan():
    # So that a failed recolour solve trips the non-finite flag.
    q = np.array([np.nan, 0.5], np.float32)
    for name, (nb, data) in {
        "TABLE_CDF": cuda_exec.cdf_layout(np.array([0.3, 0.6, 1.0], np.float32)),
        "TABLE_DISCRETE": cuda_exec.discrete_layout(np.array([0.3, 0.6, 1.0]), [1.0, 2.0, 3.0]),
        "TABLE_INTERP": cuda_exec.interp_layout([0.0, 0.5, 1.0], [1.0, 2.0, 4.0]),
    }.items():
        got = _row(name, nb, data, q)
        assert np.isnan(got[0]) and np.isfinite(got[1]), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("args", [
    ("poisson", (), {"mu": 3}), ("poisson", (), {"mu": 400}), ("poisson", (), {"mu": 2000}),
    ("poisson", (), {"mu": 5000}), ("binom", (), {"n": 200, "p": 0.5}),
    ("binom", (), {"n": 5000, "p": 0.5}), ("nbinom", (), {"n": 5, "p": 0.5}),
    ("hypergeom", (30, 25, 20), {}), ("zipf", (3.5,), {}), ("skellam", (3.0, 2.0), {}),
    ("poisson", (), {"mu": 3, "loc": 2}), ("norm", (), {}), ("geom", (0.25,), {}),
], ids=lambda a: a if isinstance(a, str) else f"{a[0]}{list(a[2].values()) or list(a[1])}")
def test_trimmed_cdf_table_matches_pallas_exec(args, dtype):
    name, a, kw = args
    config.set_dtype(getattr(torch, dtype))
    jax_config.set_dtype(getattr(jnp, dtype))
    try:
        ref = pallas_exec._trimmed_cdf_table(JaxDistribution(name, *a, **kw))
        got = cuda_exec.trimmed_cdf_table(Distribution(name, *a, **kw))
    finally:
        config.set_dtype(torch.float32)
        jax_config.set_dtype(jnp.float32)
    assert (ref is None) == (got is None)
    if ref is not None:
        assert got[1] == ref[1] and got[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], ref[0])


def _plan_pair(jax_sink, extra=()):
    mapping = interop.from_reference(jax_sink)
    ids = {jax_sink._id, *extra}
    plan = tcompile.get_plan(mapping[jax_sink._id])
    return (
        pallas_exec.supports(jax_compile.Plan(jax_sink), frozenset(ids)),
        cuda_exec.supports(plan, frozenset(mapping[i]._id for i in ids)),
    )


_RNG = np.random.default_rng(0)
SUPPORTED = {
    "discrete_small": lambda: JaxDiscrete([1, 2, 5], [0.2, 0.5, 0.3]) + 0,
    "cumulative_small": lambda: JaxCumulative([0.0, 0.5, 1.0], [10.0, 20.0, 40.0]) + 0,
    "empirical_50": lambda: JaxEmpirical(_RNG.normal(size=50)) + 0,
    "poisson_3": lambda: JaxDistribution("poisson", mu=3) + 0,
    "binom_8": lambda: JaxDistribution("binom", n=8, p=0.4) + 0,
    "nbinom_5": lambda: JaxDistribution("nbinom", n=5, p=0.5) + 0,
    "poisson_400": lambda: JaxDistribution("poisson", mu=400) + 0,
    "poisson_2000": lambda: JaxDistribution("poisson", mu=2000) + 0,
    "binom_200": lambda: JaxDistribution("binom", n=200, p=0.5) + 0,
    "binom_5000": lambda: JaxDistribution("binom", n=5000, p=0.5) + 0,
    "discrete_512": lambda: JaxDiscrete(np.arange(512.0), _RNG.dirichlet(np.ones(512))) + 0,
    "empirical_512": lambda: JaxEmpirical(_RNG.normal(size=512)) + 0,
    "hypergeom": lambda: JaxDistribution("hypergeom", 30, 25, 20) * 2,
    "table_times_normal": lambda: JaxDistribution("poisson", mu=3.5) * JaxDistribution("norm"),
}
REJECTED = {
    "composite_binom": lambda: JaxDistribution("binom", n=JaxDistribution("poisson", mu=3), p=0.4),
    "poisson_5000": lambda: JaxDistribution("poisson", mu=5000) + 0,  # 744 reachable knots
    "empirical_1000": lambda: JaxEmpirical(np.arange(1000.0)) + 0,
    "strings": lambda: JaxDiscrete(["a", "b"]) + 0,
    "closest_observation": lambda: JaxEmpirical([1.0, 2.0], method="closest_observation") + 0,
    "pchip_family": lambda: JaxDistribution("skewnorm", 3.0) + 0,
}


@pytest.mark.parametrize("name", list(SUPPORTED) + list(REJECTED))
def test_supports_agrees_with_pallas_exec_on_table_graphs(name):
    build = SUPPORTED.get(name) or REJECTED[name]
    assert _plan_pair(build()) == ((True, True) if name in SUPPORTED else (False, False))


def test_correlated_table_drivers_are_supported():
    a, c = JaxDistribution("norm"), JaxDistribution("poisson", mu=3.5)
    e = JaxEmpirical(_RNG.normal(size=40))
    sink = (a + c + e).correlate(a, c, e, corr_mat=np.eye(3))
    assert _plan_pair(sink) == (True, True)


def test_the_tables_of_a_tape_must_fit_one_block():
    # The TPU kernel has no such total cap: 24 Empirical tables of 512
    # points (10 KB each) exceed an H100 block's 227 KB of shared memory.
    nodes = [JaxEmpirical(_RNG.normal(size=512)) for _ in range(24)]
    sink = nodes[0]
    for node in nodes[1:]:
        sink = sink + node
    assert _plan_pair(sink) == (True, False)
    half = nodes[0]
    for node in nodes[1:12]:
        half = half + node
    assert _plan_pair(half) == (True, True)
    port = interop.from_reference(half)[half._id]
    tape = cuda_exec.lower(tcompile.get_plan(port), [port._id])
    assert 48 * 1024 < tape.shared_bytes <= cuda_exec.MAX_SHARED_BYTES
    assert "kTableFloats = %d;" % tape.tables.numel() in tape.source


def test_discrete_values_are_float32_in_the_kernel_and_int32_on_the_plain_path():
    # As in the JAX package: its plain path takes int32, its kernel float32.
    node = DiscreteDistribution([1, 2, 5], [0.2, 0.5, 0.3])
    sink = node + 1
    plan = tcompile.get_plan(sink)
    assert cuda_exec.supports(plan, frozenset({sink._id, node._id}))
    U = cuda_exec.philox_uniforms((3, 4), 4096, plan.d)
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, {sink._id, node._id}))
    twin = cuda_exec.run_tape(tape, U)
    plain = tcompile.build_body(plan, {sink._id, node._id})(U)
    assert twin.dtype == torch.float32 and plain[node._id].dtype == torch.int32
    assert torch.equal(twin[0], plain[node._id].float()) and torch.equal(twin[1], plain[sink._id].float())
    jax_node = JaxDiscrete([1, 2, 5], [0.2, 0.5, 0.3])
    assert np.asarray(jax_node.sample_from_quantiles(U.numpy())).dtype == np.int32


def test_table_risk_twin_matches_plain_executor():
    sink, nodes = benchmarks.table_risk()
    plan = tcompile.get_plan(sink)
    keep = frozenset([sink._id] + [n._id for n in nodes.values()])
    assert cuda_exec.supports(plan, keep)
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, keep))
    ops = [cuda_exec.OPCODES[row[0]] for row in tape.program]
    assert ops.count("TABLE_CDF") == 4 and ops.count("TABLE_DISCRETE") == 1
    assert ops.count("TABLE_INTERP") == 2
    U = cuda_exec.philox_uniforms((5, 6), 1 << 14, plan.d)
    twin = cuda_exec.run_tape(tape, U)
    ref = tcompile.build_body(plan, keep)(U)
    interp = {nodes["severity"]._id, nodes["elicited"]._id, sink._id}
    for k, nid in enumerate(tape.keep_order):
        want = ref[nid].float()
        if nid in interp:  # the kernel's slope against jnp.interp's division
            assert (twin[k] - want).abs().max() <= REL_TOL * want.abs().max()
        else:
            assert torch.equal(twin[k], want), k
    # run_program, the rows the kernel is written from, agrees bitwise.
    assert torch.equal(cuda_exec.run_program(tape, U), twin)


def test_correlated_table_twin_matches_the_generated_branch():
    sink, nodes = benchmarks.table_risk_correlated()
    plan = tcompile.get_plan(sink)
    keep = frozenset([sink._id] + [n._id for n in nodes.values()])
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, keep))
    ops = [cuda_exec.OPCODES[row[0]] for row in tape.program]
    assert ops.count("NDTR") == 3 and ops.count("SCORE_NORM") == 1
    n = 1 << 14
    words = (7, 8)
    ab = cuda_exec.recolor_transform(plan, words, n, device="cpu")
    U = cuda_exec.philox_uniforms(words, n, plan.d)
    twin = cuda_exec.run_tape(tape, U, ab)
    out, flag = cuda_exec.run(tape.to("cpu"), words, n, ab)
    assert torch.equal(out, twin) and int(flag) == 0
    ref = tcompile.build_body(plan, keep, generated=True)(U)
    for k, nid in enumerate(tape.keep_order):
        err = (twin[k] - ref[nid].float()).abs()
        if nid == nodes["orders"]._id:
            # A count: the recoloured quantile may cross a CDF step one
            # rounding of (A, b) apart.
            assert err.max() <= 1 and (err > 0).float().mean() <= 1e-3
        else:  # measured at most 1.8e-6
            assert err.max() <= REL_TOL * ref[nid].abs().max(), k


def test_generated_text_holds_no_table_value():
    def tape_of(seed):
        sink, _ = benchmarks.table_risk(seed)
        return cuda_exec.lower(tcompile.get_plan(sink), [tcompile.get_plan(sink).sink._id])

    a, b = tape_of(1), tape_of(2)
    assert a.source == b.source
    assert not torch.equal(a.tables, b.tables) and a.consts == b.consts
    assert _build.generated_key(a.source, cuda_exec._HEADERS) == _build.generated_key(
        b.source, cuda_exec._HEADERS)
    body = a.source[a.source.index("const int64_t r0"):]
    assert set(re.findall(r"\d+\.\d+f?", body)) <= {"0.0f"}
    assert "table_cdf<470>(s_tab + 0, " in a.source
    assert "table_ops.cuh" in cuda_exec._HEADERS and '#include "table_ops.cuh"' in a.source
    # Another table size is another structure.
    c = cuda_exec.lower(*(lambda s: (tcompile.get_plan(s), [s._id]))(
        DiscreteDistribution([1.0, 2.0]) + 1.0))
    d = cuda_exec.lower(*(lambda s: (tcompile.get_plan(s), [s._id]))(
        DiscreteDistribution([1.0, 2.0, 3.0]) + 1.0))
    assert c.source != d.source


def test_tape_to_moves_the_tables():
    sink = CumulativeDistribution([0, 0.5, 1], [1.0, 2.0, 4.0]) + EmpiricalDistribution([1.0, 3.0])
    tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
    moved = tape.to("meta")
    assert moved.tables.device.type == "meta" and moved.tables.shape == tape.tables.shape
    assert tape.tables.numel() % 4 == 0 and tape.tables.dtype == torch.float32
    assert tape.shared_bytes == 4 * tape.tables.numel()


def test_cuda_executor_refuses_string_tables():
    node = DiscreteDistribution(["a", "b"])
    with pytest.raises(ValueError, match="executor='cuda' requires"):
        node.sample(10, random_state=0, gc_strategy=[], executor="cuda")
    plan = tcompile.get_plan(tg.Add(DiscreteDistribution([1.0, 2.0]), 1.0))
    assert cuda_exec.supports(plan, frozenset({plan.sink._id}))
