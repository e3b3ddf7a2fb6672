"""K1's Newton tier on the CPU: its Python transcription and its text.

* ``engine/newton_tier.py`` transcribes ``csrc/newton_ops.cuh`` lane by
  lane: the 15 Newton families' inverse arguments and values, the twin's
  safeguarded Newton loop and per-lane freeze, and the series and
  continued fractions that stop where they have converged (term <= total
  * 2^-24, |d c - 1| <= 2^-24) within the twin's 48 terms and 40 pairs.
  Its inverse at each family's arguments, at the JAX package's sweep
  shapes, at the family's cap (a = 30, df = 60) and at a small shape
  (0.1), matches the twin's (``ops/special.py`` under
  ``kernel_safe_special``) and the JAX package's ``gammaincinv`` or
  ``betaincinv`` under its own ``kernel_safe_special`` within 1e-4 of the
  largest value, on quantiles in [0.001, 0.999]; so does each family's
  value at the sweep shapes, as ``chip_smoke.py`` holds the kernel's
  Newton nodes to the twin.
* A lane's value is its own: bitwise the same when its batch is
  shuffled, sliced or padded.
* The generated text: a tape without a Newton row carries none of the
  tier (no solve, no shared quantiles, no block-wide loop); a tape with
  R of them covers ``NEWTON_SLOTS // R`` groups a thread in each turn (as
  shared memory allows), writes their quantiles before one solve, gamma
  rows first, and reads each value back in its row's place.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu.ops import ppf as jax_ppf
from probabilit_tpu.ops import special as jax_special
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, newton_tier
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models import graph as tg
from probabilit_tpu_torch.models.distributions import Distribution, EmpiricalDistribution
from probabilit_tpu_torch.ops import ppf, special
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
Q = np.linspace(0.001, 0.999, 2001).astype(np.float32)
SWEEP = {f[0]: f[1] for f in benchmarks.FAMILY_SWEEP if f[0] in cuda_exec.INCOMPLETE_FAMILY_CAPS}
# Each family at its cap (gengamma's c is no shape the caps bound) and at
# a small shape.
CAP = {
    "gamma": (30.0,), "invgamma": (30.0,), "chi2": (60.0,), "chi": (60.0,), "nakagami": (30.0,),
    "beta": (30.0, 30.0), "betaprime": (30.0, 30.0), "t": (60.0,), "f": (60.0, 60.0),
    "dgamma": (30.0,), "loggamma": (30.0,), "gengamma": (30.0, 1.5), "rdist": (60.0,),
    "argus": (60.0,),
}
SMALL = {
    "gamma": (0.1,), "invgamma": (0.1,), "chi2": (0.1,), "chi": (0.1,), "nakagami": (0.1,),
    "beta": (0.1, 0.1), "betaprime": (0.1, 0.1), "t": (0.1,), "f": (0.1, 0.1),
    "dgamma": (0.1,), "loggamma": (0.1,), "gengamma": (0.1, 1.5), "rdist": (0.1,),
    "argus": (0.1,),
}
CASES = (
    [(name, tuple(args)) for name, args in SWEEP.items()]
    + [(name, args) for name, args in CAP.items()]
    + [(name, args) for name, args in SMALL.items()]
)


def _id(case):
    name, args = case
    return name + "".join(f"-{a:g}" for a in args)


def test_the_cases_cover_every_newton_family():
    assert set(SWEEP) == set(cuda_exec.INCOMPLETE_FAMILY_CAPS) == set(cuda_exec.NEWTON_KIND)
    # The generated text names each family by its id in the header's enum.
    header = (Path(cuda_exec.__file__).parents[1] / "csrc" / "newton_ops.cuh").read_text()
    enum = header[header.index("enum Family : int {"):]
    enum = enum[:enum.index("};")]
    assert sorted(re.findall(r"kFam\w+", enum)) == sorted(cuda_exec._NEWTON_FAMILY_ID.values())
    assert set(CAP) == set(SMALL) == set(SWEEP) - {"maxwell"}  # maxwell has no shape
    for name, args in CAP.items():
        assert float(args[0]) == cuda_exec.INCOMPLETE_FAMILY_CAPS[name]


def _inverses(name, args):
    """(kind, tier's x, trips, inner, twin's x, JAX's x) of a family's
    inverse at its arguments on ``Q``."""
    q = torch.from_numpy(Q)
    kind, a, b, p = newton_tier.family_args(name, q, args)
    with special.kernel_safe_special():
        if kind == "gamma":
            x, trips, inner = newton_tier.gammaincinv(a, p)
            twin = special.gammaincinv(a, p)
        else:
            x, trips, inner = newton_tier.betaincinv(a, b, p)
            twin = special.betaincinv(a, b, p)
    operands = [jnp.asarray(v.numpy()) for v in ((a, p) if kind == "gamma" else (a, b, p))]
    with jax_special.kernel_safe_special():
        fn = jax_special.gammaincinv if kind == "gamma" else jax_special.betaincinv
        ref = np.asarray(jax.jit(fn)(*operands))
    return kind, x.numpy(), trips, inner, twin.numpy(), ref


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_transcription_matches_twin_and_jax(case):
    # The loop's inverse at the family's arguments, against the twin's and
    # the JAX package's gammaincinv or betaincinv.
    name, args = case
    kind, x, trips, inner, twin, ref = _inverses(name, args)
    assert kind == cuda_exec.NEWTON_KIND[name]
    assert np.isfinite(x).all()
    scale = np.abs(twin).max()
    assert np.abs(x - twin).max() <= REL_TOL * scale
    assert np.abs(x - ref).max() <= REL_TOL * scale
    # Every lane within the twin's caps: trips, and terms or pairs a trip.
    caps = {"gamma": (newton_tier.GAMMA_TRIPS, newton_tier.GAMMA_TERMS),
            "beta": (newton_tier.BETA_TRIPS, newton_tier.BETA_PAIRS)}[kind]
    assert int(trips.min()) >= 1 and int(trips.max()) <= caps[0]
    assert bool((inner >= trips).all()) and bool((inner <= trips * caps[1]).all())


@pytest.mark.parametrize("name", list(SWEEP))
def test_family_value_matches_twin_and_jax(name):
    # The family's standard variate at chip_smoke.py's family-graph shapes,
    # as phase 14 holds the kernel's Newton nodes.
    args = SWEEP[name]
    q = torch.from_numpy(Q)
    got = newton_tier.ppf(name, q, args)[0].numpy()
    with special.kernel_safe_special():
        twin = ppf.call(name, q, *args).numpy()
    with jax_special.kernel_safe_special():
        ref = np.asarray(jax.jit(lambda q: jax_ppf.call(name, q, *args))(jnp.asarray(Q)))
    assert np.isfinite(got).all()
    assert np.abs(got - twin).max() <= REL_TOL * np.abs(twin).max()
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["gamma", "beta"])
def test_inverses_match_jax(kind):
    rng = np.random.default_rng(7 if kind == "gamma" else 8)
    p = rng.uniform(0.001, 0.999, 3000).astype(np.float32)
    a = rng.uniform(0.1, 30.0, 3000).astype(np.float32)
    b = rng.uniform(0.1, 30.0, 3000).astype(np.float32)
    with jax_special.kernel_safe_special():
        if kind == "gamma":
            ref = np.asarray(jax.jit(jax_special.gammaincinv)(jnp.asarray(a), jnp.asarray(p)))
        else:
            ref = np.asarray(
                jax.jit(jax_special.betaincinv)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(p)))
    if kind == "gamma":
        got = newton_tier.gammaincinv(torch.from_numpy(a), torch.from_numpy(p))[0].numpy()
    else:
        got = newton_tier.betaincinv(
            torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(p))[0].numpy()
    # Relative to each lane's own value: a's range spans two decades.
    assert np.all(np.abs(got - ref) <= REL_TOL * np.maximum(np.abs(ref), 1.0))


def test_the_stopped_fractions_take_fewer_steps_than_the_twin():
    # The twin runs every trip's fraction to its fixed count; the tier
    # stops where it has converged, on the same trips.
    q = torch.from_numpy(Q)
    for name, args in (("t", (4.0,)), ("gamma", (2.5,)), ("beta", (3.4, 2.6))):
        _, kind, trips, inner = newton_tier.ppf(name, q, args)
        fixed = newton_tier.GAMMA_TERMS if kind == "gamma" else newton_tier.BETA_PAIRS
        assert float(inner.sum()) < 0.25 * fixed * float(trips.sum())


@pytest.mark.parametrize("name", ["t", "gamma", "beta", "argus", "gengamma"])
def test_a_lane_value_is_its_own(name):
    rng = np.random.default_rng(11)
    q = torch.from_numpy((rng.integers(1, 2**24, 2051) / 2.0**24).astype(np.float32))
    args = SWEEP[name]
    whole = newton_tier.ppf(name, q, args)[0]
    perm = torch.from_numpy(rng.permutation(q.numel()))
    assert torch.equal(newton_tier.ppf(name, q[perm], args)[0], whole[perm])
    assert torch.equal(newton_tier.ppf(name, q[7:20], args)[0], whole[7:20])
    padded = torch.cat([q, torch.full((5,), 0.5)])
    assert torch.equal(newton_tier.ppf(name, padded, args)[0][:-5], whole)
    assert torch.equal(newton_tier.ppf(name, q[3:4], args)[0], whole[3:4])


def test_newton_graph_nodes_match_the_twin():
    # The slice as a whole: each Newton node of chip_smoke.py's family
    # graph through the transcription and through the twin's tape, on the
    # same Philox uniforms.
    sink, nodes = benchmarks.family_graphs()["newton"]
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {node._id for _, node in nodes}
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, keep))
    U = cuda_exec.philox_uniforms(cuda_exec.seed_words(3), 4096, plan.d)
    twin = cuda_exec.run_tape(tape, U)
    for name, node in nodes:
        q = U[:, plan.col_of[node._id]]
        x = newton_tier.ppf(name, q, SWEEP[name])[0]
        loc, scale = node.kwargs.get("loc", 0.0), node.kwargs.get("scale", 1.0)
        got = loc + scale * x
        want = twin[tape.keep_order.index(node._id)]
        central = (q >= 0.001) & (q <= 0.999)
        err = (got - want).abs()[central].max()
        assert err <= REL_TOL * want.abs().max(), name


def _tape(sink):
    plan = tcompile.get_plan(sink)
    return cuda_exec.lower(plan, [sink._id])


TIER_WORDS = ("newton_ops::", "s_newton", "s_rows", "s_next", "live_groups", "kTurn")


@pytest.mark.parametrize("label", ["mixed_dag_20", "mixed_correlated_50", "closed_form_0",
                                   "large_table", "table_risk", "breach_count", "typed_ops"])
def test_text_without_newton_rows_has_no_tier(label):
    graphs = benchmarks.family_graphs()
    sink = {
        "mixed_dag_20": benchmarks.mixed_dag_20,
        "mixed_correlated_50": benchmarks.mixed_correlated_50,
        "closed_form_0": lambda: graphs["closed_form_0"][0],
        "large_table": benchmarks.large_table,
        "table_risk": lambda: benchmarks.table_risk()[0],
        "breach_count": lambda: benchmarks.breach_count()[0],
        "typed_ops": lambda: benchmarks.typed_ops()[0],
    }[label]()
    tape = _tape(sink)
    assert tape.newton_rows == () and tape.newton_groups == 0 and tape.slot_floats == 0
    kernel = tape.source[tape.source.index("__global__"):tape.source.index("}  // namespace")]
    for word in TIER_WORDS:
        assert word not in kernel
    assert "kSlotFloats = 0;" in tape.source and "kGroups = 1;" in tape.source
    assert "__syncthreads" not in kernel[kernel.index("bool bad = false;"):]
    assert "for (uint64_t g = g_first" in kernel  # the grid-stride loop of every thread


@pytest.mark.parametrize("rows", [1, 2, 5, 12, 13, 18])
def test_a_turn_covers_slots_for_twelve_rows(rows):
    # NEWTON_SLOTS // R groups a thread, at least one: 1 -> 12, 2 -> 6,
    # 5 -> 2, 12 and more -> 1.
    sink = tg.Add(*[Distribution("t", 4.0 + i) for i in range(rows)], Distribution("norm"))
    tape = _tape(sink)
    assert len(tape.newton_rows) == rows
    assert tape.newton_groups == max(1, cuda_exec.NEWTON_SLOTS // rows)
    assert tape.slot_floats == tape.newton_groups * rows * cuda_exec._TILE
    assert f"kGroups = {tape.newton_groups};" in tape.source
    assert tape.source.count("newton_ops::solve<kThreads, kGroups, kFamilies>(") == 1


def test_newton_rows_are_numbered_gamma_first():
    # Betas and gammas alternating, and a normal: one solve of all the
    # Newton rows, gammas first; each quantile written before the solve,
    # each value read after it, one line a lane.
    nodes = [Distribution("t", 4.0) if i % 2 else Distribution("gamma", 2.0) for i in range(6)]
    sink = tg.Add(*nodes, Distribution("norm"))
    tape = _tape(sink)
    text = tape.source
    assert "__shared__ newton_ops::Row s_rows[6];" in text
    made = [line for line in text.splitlines() if "make_row<kFamilies>(" in line]
    families = [line.split("newton_ops::kFam")[1].split(",")[0] for line in made]
    assert families == ["Gamma"] * 3 + ["T"] * 3
    rows, feeders, first = cuda_exec._newton_plan(tape)
    assert sorted(first) == sorted(f for chain in feeders.values() for f in chain)
    solve = ("newton_ops::solve<kThreads, kGroups, kFamilies>(s_newton, s_rows, &s_next, 6,\n"
             "                                                    live_groups);")
    assert ("constexpr unsigned kFamilies = (1u << newton_ops::kFamGamma) | "
            "(1u << newton_ops::kFamT);") in text
    before, after = text.split(solve)
    groups = tape.newton_groups
    for j, i in enumerate(rows):
        dst = tape.program[i][1]
        q = tape.program[feeders[i][-1]][1]
        for lane in range(cuda_exec.LANES):
            at = f"{(j * groups * cuda_exec.LANES + lane) * cuda_exec._THREADS} + sub * {cuda_exec._TILE}"
            assert f"s_newton[{at} + threadIdx.x] = v{q}_{lane};" in before
            assert f"const float v{dst}_{lane} = s_newton[{at} + threadIdx.x];" in after
            assert f"v{q}_{lane} =" not in after  # the quantile is not drawn twice
    assert after.count("if (live) store_group(") == 1


def test_correlated_newton_rows_write_their_recoloured_quantile():
    sink, _ = benchmarks.portfolio_var()
    tape = _tape(sink)
    (i,) = tape.newton_rows
    rows, feeders, first = cuda_exec._newton_plan(tape)
    assert rows == [i]
    assert [cuda_exec.OPCODES[tape.program[f][0]] for f in feeders[i]] == ["RECOLOR", "NDTR"]
    # Before the solve: every score and its draw, then the recolour and the
    # normal CDF of the t driver.
    names = [cuda_exec.OPCODES[tape.program[f][0]] for f in first]
    assert names == ["DRAW", "SCORE"] * tape.n_corr + ["RECOLOR", "NDTR"]
    assert "newton_ops::make_row<kFamilies>(newton_ops::kFamT, k.v[" in tape.source


def test_the_groups_shrink_to_fit_the_tables():
    # A tape whose tables leave room for fewer groups than NEWTON_SLOTS // R.
    rng = np.random.default_rng(3)
    tables = [EmpiricalDistribution(rng.normal(size=512)) for _ in range(18)]
    newton = [Distribution("gamma", 2.0 + i) for i in range(2)]
    tape = _tape(tg.Add(*tables, *newton))
    free = cuda_exec.MAX_SHARED_BYTES - 4 * tape.tables.numel() - (20 * 2 + 4)
    assert tape.newton_groups == free // (4 * cuda_exec._TILE * 2)
    assert 1 <= tape.newton_groups < cuda_exec.NEWTON_SLOTS // 2
    assert tape.shared_bytes <= cuda_exec.MAX_SHARED_BYTES
