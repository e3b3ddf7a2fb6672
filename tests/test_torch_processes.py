"""The port's path processes, on the CPU: the Brownian bridge, the five
single-asset families of ``models/processes.py`` (Brownian, GBM, OU,
Poisson, Merton) and their functionals, and the engine's quantile slab.

This file also holds the battery that ``test_torch_joint_paths.py``,
``test_torch_sde_markov.py`` and ``test_torch_levy_stochvol.py`` run on
their own factories (``Case`` and the ``check_*`` functions):

* quantile-mode parity: the same numpy uniforms (float32-exact, in [0.001,
  0.999] for a factory that runs a Newton ppf) through the JAX package's
  ``sample_from_quantiles`` and the port's, the port's graph built by
  ``interop.from_reference``; every path within 1e-4 of its largest
  magnitude in float32 (the DAG tolerance) and within 1e-9 of it in
  float64.  Poisson counts and Markov states must be equal; a row with a
  count or chain uniform within 4 ulps of a CDF boundary is exempt, and
  the battery counts such rows (none in these tests' data);
* the terminal law in ``method=None`` mode, where the port draws its own
  bits from a generator keyed by the node's column: mean (and variance
  where a closed form exists) within 5 standard errors;
* ``d_total``: the node's own column plus ``_q_width - 1`` extra columns,
  and the width error that names the path-driver columns;
* a streamed ``method="sobol"`` run of the time average equal to the
  one-shot run bit for bit;
* ``copy()`` and the functional memo;
* the refusals: ``correlate`` of a vector-valued node, ``executor="cuda"``
  (both packages' ``supports`` refuse a path graph), streaming a
  vector-valued sink.

Sizes: at most 16 steps and 2^12 paths where the JAX package runs (it
compiles each program; 2^10 paths where it runs a Newton ppf, whose
float64 solve takes about a second per 2^10 paths on the CPU), at most
2^16 paths x 32 steps in the port-only tests.
"""

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

import probabilit_tpu as jax_pkg
import probabilit_tpu_torch as pt
from probabilit_tpu import config as jax_config
from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import pallas_exec
from probabilit_tpu.ops import bridge as jax_bridge
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, streaming
from probabilit_tpu_torch.models.processes import PathFunctional
from probabilit_tpu_torch.ops import bridge
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

F32_TOL = 1e-4  # of each path's largest magnitude, float32 (the DAG tolerance)
F64_TOL = 1e-9  # the same, float64
BOUNDARY_ULPS = 4  # a count or chain uniform this close to a CDF boundary is exempt
N_PARITY = 1 << 12
N_PARITY_NEWTON = 1 << 10  # the JAX package's float64 Newton solves run ~1 s per 2^10 paths
N_LAW = 1 << 16
SE = 5.0


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


# --- The battery --------------------------------------------------------------------------


@dataclass
class Case:
    """One factory: ``build(pkg)`` makes the path surface (a path node, or
    an asset view) with ``pkg``'s factories; ``law(surface, n, seed)``
    checks its terminal law; ``count_uniforms(node, slab)`` lists the
    (uniforms, float64 CDF table) pairs of its discrete drivers."""

    build: object
    law: object
    newton: bool = False
    count_uniforms: object = field(default=None)


def path_node(surface):
    """The node that owns the randomness: the path, or a view's joint."""
    return getattr(surface, "joint", surface)


def quantiles(n, d, seed, newton=False):
    """Float32-exact uniforms in (0, 1), in [0.001, 0.999] for a Newton
    ppf (in the float32 tails the two packages' Newton solves part)."""
    q = np.random.default_rng(seed).integers(1, 2**23, (n, d)) / 2**23
    return 0.001 + 0.998 * q if newton else q


def near_boundary(u, table, dtype):
    """Rows of ``u`` with an entry within ``BOUNDARY_ULPS`` ulps of an
    entry of the CDF ``table`` (both rounded to ``dtype``)."""
    u = np.asarray(u, dtype)
    t = np.asarray(table, dtype)
    j = np.clip(np.searchsorted(t, u), 0, len(t) - 1)
    gap = np.minimum(np.abs(u - t[j]), np.abs(u - t[np.maximum(j - 1, 0)]))
    close = gap <= BOUNDARY_ULPS * np.spacing(np.abs(u))
    return close.reshape(close.shape[0], -1).any(axis=1)


def poisson_table(mu):
    kmax = int(np.ceil(mu + 12.0 * np.sqrt(mu + 1.0) + 30.0))
    return sps.poisson.cdf(np.arange(kmax + 1), mu)


def check_parity(case, dtype, seed=0):
    """Quantile-mode parity with the JAX package on one slab."""
    ref = path_node(case.build(jax_pkg))
    port = interop.from_reference(ref)[ref._id]
    plan = tcompile.get_plan(port)
    n = N_PARITY_NEWTON if case.newton else N_PARITY
    q = quantiles(n, plan.d_total, seed, case.newton)
    want = np.asarray(ref.sample_from_quantiles(q))
    got = port.sample_from_quantiles(q).numpy()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    exempt = np.zeros(n, bool)
    if case.count_uniforms is not None:
        slab = q[:, list(plan.columns_of(port))]
        for u, table in case.count_uniforms(port, slab):
            exempt |= near_boundary(u, table, dtype)
    assert exempt.sum() <= n // 100, exempt.sum()
    rows = ~exempt
    a, b = want[rows].reshape(rows.sum(), -1), got[rows].reshape(rows.sum(), -1)
    scale = np.abs(a).max(axis=1, keepdims=True)
    tol = (F32_TOL if dtype == np.float32 else F64_TOL) * scale
    err = np.abs(b - a)
    assert np.all(err <= tol), float((err / np.maximum(scale, 1e-300)).max())
    return int(exempt.sum())


def check_width(case):
    """``d_total`` and the width error's path-driver columns."""
    surface = case.build(pt)
    node = path_node(surface)
    sink = surface.terminal() + pt.Distribution("norm")
    plan = tcompile.get_plan(sink)
    extra = node._q_width - 1
    assert plan.d == 2 and plan.d_total == 2 + extra
    own = plan.col_of[node._id]
    assert plan.columns_of(node) == (own, *range(2, 2 + extra))
    with pytest.raises(ValueError, match=f"2 scalar columns \\+ {extra} path-driver columns"):
        sink.sample_from_quantiles(quantiles(64, 2, 1))
    out = sink.sample_from_quantiles(quantiles(64, plan.d_total, 1, case.newton))
    assert out.shape == (64,) and bool(torch.isfinite(out).all())


def check_streamed(case, n=512, block=128):
    """A streamed Sobol run equals the one-shot run bit for bit (of the
    time average: the whole path and its reduction over the steps)."""
    t = case.build(pt).average()
    full = t.sample(n, random_state=3, method="sobol").numpy()
    blocks = streaming.sample_streaming(t, n, block_size=block, random_state=3, method="sobol")
    np.testing.assert_array_equal(full, blocks)
    est = streaming.estimate(t, n, block_size=block, random_state=3, method="sobol")
    assert est["mean"] == pytest.approx(float(full.astype(np.float64).mean()), rel=1e-12)


def check_copy_and_memo(case):
    surface = case.build(pt)
    assert surface.terminal() is surface.terminal()
    assert surface.at(1) is surface.at(1) and surface.at(1) is not surface.at(0)
    payoff = surface.maximum() - surface.terminal() + surface.average()
    base = payoff.sample(256, random_state=4).numpy()
    clone = payoff.copy()
    np.testing.assert_array_equal(clone.sample(256, random_state=4).numpy(), base)
    copied = [n for n in clone.unique_nodes() if type(n) is type(surface) and n is not surface]
    assert len(copied) == 1
    fresh = copied[0].terminal()
    assert fresh.path is copied[0] and fresh is not surface.terminal()


def check_refusals(case):
    surface = case.build(pt)
    node = path_node(surface)
    x = pt.Distribution("norm")
    sink = (surface.terminal() + x).correlate(node, x, corr_mat=np.eye(2))
    with pytest.raises(ValueError, match="vector-valued"):
        sink.sample(100, random_state=0)
    payoff = surface.terminal() * 2.0
    plan = tcompile.get_plan(payoff)
    assert not cuda_exec.supports(plan, {payoff._id})
    with pytest.raises(ValueError, match="path processes"):
        payoff.sample(64, random_state=0, gc_strategy=[], executor="cuda")
    with pytest.raises(ValueError, match="vector-valued"):
        streaming.sample_streaming(surface, 64, block_size=32, random_state=0)
    with pytest.raises(ValueError, match="vector-valued"):
        streaming.estimate(node, 64, block_size=32, random_state=0)
    ref = case.build(jax_pkg).terminal() * 2.0
    assert not pallas_exec.supports(jax_compile.get_plan(ref), frozenset({ref._id}))


def within_se(x, mean, var=None, label=""):
    """The sample mean (and variance, where given) of ``x`` within ``SE``
    standard errors of the closed forms."""
    x = np.asarray(x, np.float64)
    n = x.size
    se = x.std() / np.sqrt(n)
    assert abs(x.mean() - mean) <= SE * se, (label, x.mean(), mean, se)
    if var is not None:
        m4 = ((x - x.mean()) ** 4).mean()
        se_var = np.sqrt(max(m4 - x.var() ** 2, 0.0) / n)
        assert abs(x.var() - var) <= SE * se_var, (label, x.var(), var, se_var)


def run_battery(cases, test):
    """The battery's tests over ``cases`` (a dict), for a test file's
    namespace."""
    names = sorted(cases)

    @pytest.mark.parametrize("name", names)
    def test_quantile_mode_matches_jax(name, both_dtypes):
        check_parity(cases[name], both_dtypes)

    @pytest.mark.parametrize("name", names)
    def test_terminal_law_in_key_mode(name):
        case = cases[name]
        case.law(case.build(pt), N_LAW, 11)

    @pytest.mark.parametrize("name", names)
    def test_width_and_its_error(name):
        check_width(cases[name])

    @pytest.mark.parametrize("name", names)
    def test_streamed_sobol_equals_one_shot(name):
        check_streamed(cases[name])

    @pytest.mark.parametrize("name", names)
    def test_copy_and_memo(name):
        check_copy_and_memo(cases[name])

    @pytest.mark.parametrize("name", names)
    def test_refusals(name):
        check_refusals(cases[name])

    for fn in (test_quantile_mode_matches_jax, test_terminal_law_in_key_mode,
               test_width_and_its_error, test_streamed_sobol_equals_one_shot,
               test_copy_and_memo, test_refusals):
        test[fn.__name__] = fn


# --- The five single-asset families --------------------------------------------------------


def terminal(surface, n, seed):
    return surface.terminal().sample(n, random_state=seed).numpy()


def brownian_law(w, n, seed):
    within_se(terminal(w, n, seed), 1.0 + 0.3 * 2.0, 1.5**2 * 2.0, "brownian")
    # at(7) is time 8 dt = 1.
    within_se(w.at(7).sample(n, random_state=seed + 1).numpy(), 1.0 + 0.3 * 1.0,
              1.5**2 * 1.0, "brownian at(7)")


def gbm_law(g, n, seed):
    s = terminal(g, n, seed)
    within_se(s, 100 * np.exp(0.05), 100**2 * np.exp(0.1) * np.expm1(0.04), "gbm")
    within_se(np.log(s / 100), 0.05 - 0.02, 0.04, "gbm log")


def ou_law(ou, n, seed):
    a = np.exp(-1.5 * 1.0)
    within_se(terminal(ou, n, seed), 0.5 + (2.0 - 0.5) * a, 0.8**2 * (1 - a * a) / 3.0, "ou")


def poisson_law(pp, n, seed):
    within_se(terminal(pp, n, seed), 6.0, 6.0, "poisson")


def merton_law(mj, n, seed):
    lr = np.log(terminal(mj, n, seed) / 100.0)
    mean = 0.03 - 0.02 + 1.0 * (-0.05)
    var = 0.04 + 1.0 * (0.05**2 + 0.1**2)
    within_se(lr, mean, var, "merton log")


def poisson_counts(node, slab):
    return [(slab[:, : node.steps], poisson_table(node.rate * node.T / node.steps))]


def merton_counts(node, slab):
    s = node.steps
    return [(slab[:, s : 2 * s], poisson_table(node.jump_rate * node.T / s))]


CASES = {
    "brownian": Case(
        lambda p: p.BrownianMotion(x0=1.0, drift=0.3, diffusion=1.5, T=2.0, steps=16), brownian_law),
    "gbm": Case(lambda p: p.GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=16), gbm_law),
    "ou": Case(lambda p: p.OrnsteinUhlenbeck(x0=2.0, theta=1.5, mu=0.5, sigma=0.8, steps=16), ou_law),
    "poisson": Case(lambda p: p.PoissonProcess(rate=3.0, T=2.0, steps=16), poisson_law,
                    count_uniforms=poisson_counts),
    "merton": Case(
        lambda p: p.MertonJumpDiffusion(s0=100, mu=0.03, sigma=0.2, jump_rate=1.0,
                                        jump_mean=-0.05, jump_std=0.1, steps=16),
        merton_law, count_uniforms=merton_counts),
}

run_battery(CASES, globals())


# --- The bridge -----------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 2, 3, 7, 8, 252])
def test_bridge_matrices_equal_the_jax_packages(steps):
    B = bridge.bridge_matrix(steps)
    A = bridge.increment_matrix(steps)
    np.testing.assert_array_equal(B, jax_bridge.bridge_matrix(steps))
    np.testing.assert_array_equal(A, jax_bridge.increment_matrix(steps))
    grid = np.arange(1, steps + 1, dtype=float)
    np.testing.assert_allclose(B @ B.T, np.minimum.outer(grid, grid), atol=1e-9)
    np.testing.assert_allclose(A @ A.T, np.eye(steps), atol=1e-12)
    assert B[-1, 0] == pytest.approx(np.sqrt(steps)) and np.all(B[-1, 1:] == 0.0)


@pytest.mark.parametrize("steps", [1, 252])
def test_normal_increments_match_jax(steps, both_dtypes):
    q = quantiles(512, steps, steps)
    want = np.asarray(jax_bridge.normal_increments(jnp.asarray(q), jax_config.float_dtype()))
    got = bridge.normal_increments(torch.from_numpy(q), config.float_dtype()).numpy()
    assert got.dtype == want.dtype == both_dtypes
    tol = 1e-5 if both_dtypes == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_bridge_product_runs_with_tf32_off(monkeypatch):
    """The product sees TF32 off, and the caller's setting comes back."""
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        bridge.normal_increments(torch.full((4, 8), 0.3), torch.float32)
        assert seen == [False] and torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def test_bridge_rows_do_not_depend_on_the_batch():
    """A row's increments are the same in one call and in blocks, bitwise
    (what a streamed method= run relies on)."""
    u = torch.from_numpy(quantiles(4096, 252, 9)).float()
    whole = bridge.normal_increments(u, torch.float32)
    blocks = torch.cat([bridge.normal_increments(u[i : i + 1000], torch.float32)
                        for i in range(0, 4096, 1000)])
    torch.testing.assert_close(whole, blocks, rtol=0, atol=0)


# --- Functionals, the engine's contract, the surface --------------------------------------


def test_functionals_against_the_path():
    g = pt.GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=16)
    sink = pt.NoOp(g.terminal(), g.maximum(), g.minimum(), g.average(), g.at(3))
    sink.sample(1024, random_state=4)
    paths = g.samples_
    assert paths.shape == (1024, 16)
    torch.testing.assert_close(g.terminal().samples_, paths[:, -1], rtol=0, atol=0)
    torch.testing.assert_close(g.maximum().samples_, paths.amax(dim=1), rtol=0, atol=0)
    torch.testing.assert_close(g.minimum().samples_, paths.amin(dim=1), rtol=0, atol=0)
    torch.testing.assert_close(g.average().samples_, paths.mean(dim=1), rtol=0, atol=0)
    torch.testing.assert_close(g.at(3).samples_, paths[:, 3], rtol=0, atol=0)
    with pytest.raises(ValueError, match="step must be in"):
        g.at(16)
    with pytest.raises(TypeError, match="PathDistribution"):
        PathFunctional(pt.Distribution("norm"), "max")
    with pytest.raises(ValueError, match="index is required"):
        PathFunctional(g, "at")


def test_ou_scan_survives_strong_mean_reversion():
    """theta*T = 2000: a rescaling by a^-k would overflow float32; the
    doubling scan only multiplies powers of a <= 1."""
    ou = pt.OrnsteinUhlenbeck(x0=5.0, theta=2000.0, mu=0.5, sigma=0.1, T=1.0, steps=32)
    x = ou.sample(4096, random_state=0)
    assert bool(torch.isfinite(x).all())
    within_se(x[:, -1].numpy(), 0.5, 0.01 / 4000.0, "stiff ou")


def test_ou_scan_matches_the_recurrence_in_float64(both_dtypes):
    """The doubling scan against the step-by-step recurrence it replaces."""
    ou = pt.OrnsteinUhlenbeck(x0=2.0, theta=1.5, mu=0.5, sigma=0.8, steps=37)
    inc = torch.randn(64, 37, dtype=config.float_dtype(), generator=torch.Generator().manual_seed(0))
    got = ou._path_from_increments(inc)
    a = float(np.exp(-1.5 / 37))
    x, want = 2.0, []
    for k in range(37):
        x = a * x + inc[:, k].double()
        want.append(x)
    want = torch.stack(want, dim=1)
    tol = 1e-5 if both_dtypes == np.float32 else 1e-13
    torch.testing.assert_close(got.double(), want, rtol=0, atol=tol * float(want.abs().max()))


def test_plain_graph_keeps_its_width_and_stream():
    """A graph without a path node: d_total == d, and method=None draws d
    columns, so its stream is the parent's."""
    x = pt.Distribution("norm") + pt.Distribution("expon")
    plan = tcompile.get_plan(x)
    assert plan.d_total == plan.d == 2 and plan.slab_of == {}
    from probabilit_tpu_torch.ops import qmc

    q = qmc.uniform(7, 1000, 2, torch.float32, "cpu")
    torch.testing.assert_close(x.sample(1000, random_state=7), x.sample_from_quantiles(q),
                               rtol=0, atol=0)


def test_key_mode_reads_one_column_and_is_reproducible():
    g = pt.GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=8)
    sink = g.terminal() + pt.Distribution("norm")
    plan = tcompile.get_plan(sink)
    assert (plan.d, plan.d_total) == (2, 9)
    a = sink.sample(2048, random_state=3)
    b = sink.sample(2048, random_state=3)
    c = sink.sample(2048, random_state=4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # The path's draws are keyed by its one column of the (n, d) matrix.
    from probabilit_tpu_torch.ops import multivariate as mv
    from probabilit_tpu_torch.ops import qmc

    q = qmc.uniform(4, 2048, 2, torch.float32, "cpu")  # c's draws, the last
    inc = g._increments(mv._key_from_q(q[:, plan.col_of[g._id]]), 2048, torch.float32)
    torch.testing.assert_close(g.samples_, g._path_from_increments(inc), rtol=0, atol=0)


def test_from_reference_carries_functionals_into_the_memo():
    ref_g = jax_pkg.GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=8)
    ref = (ref_g.maximum() < 130) * (ref_g.terminal() - 100)
    mapping = interop.from_reference(ref)
    g = mapping[ref_g._id]
    assert type(g).__name__ == "GBMPath" and (g.s0, g.mu, g.sigma, g.steps) == (100, 0.05, 0.2, 8)
    assert mapping[ref_g.terminal()._id] is g.terminal()
    assert mapping[ref_g.maximum()._id] is g.maximum()
    port = mapping[ref._id]
    q = quantiles(256, tcompile.get_plan(port).d_total, 5)
    np.testing.assert_allclose(port.sample_from_quantiles(q).numpy(),
                               np.asarray(ref.sample_from_quantiles(q)), rtol=1e-5, atol=1e-4)


def test_the_fifteen_factories_are_exported():
    for name in ("BrownianMotion", "GeometricBrownianMotion", "OrnsteinUhlenbeck",
                 "PoissonProcess", "MertonJumpDiffusion", "CorrelatedGBM", "CorrelatedMerton",
                 "VarianceGamma", "NormalInverseGaussian", "CoxIngersollRoss", "Heston",
                 "CorrelatedHeston", "SDE", "MarkovChain", "RegimeSwitchingGBM",
                 "PathDistribution", "PathFunctional"):
        assert name in pt.__all__ and callable(getattr(pt, name))
        assert name in jax_pkg.__all__ or name in ("PathDistribution", "PathFunctional")


def test_validation_matches_the_jax_package():
    for build, match in (
        (lambda p: p.BrownianMotion(steps=0), "steps"),
        (lambda p: p.BrownianMotion(T=0.0), "T must be positive"),
        (lambda p: p.BrownianMotion(diffusion=0.0), "diffusion"),
        (lambda p: p.GeometricBrownianMotion(s0=0.0), "s0"),
        (lambda p: p.OrnsteinUhlenbeck(theta=0.0), "theta"),
        (lambda p: p.PoissonProcess(rate=0.0), "rate"),
        (lambda p: p.MertonJumpDiffusion(jump_std=-1.0), "jump_std"),
    ):
        for pkg in (jax_pkg, pt):
            with pytest.raises(ValueError, match=match):
                build(pkg)


def test_single_step_path_under_sobol():
    w = pt.BrownianMotion(steps=1)
    s = w.terminal().sample(4096, random_state=0, method="sobol").numpy()
    assert sps.kstest(s, "norm").pvalue > 0.01


def test_antithetic_pairs_reflect_brownian_paths():
    w = pt.BrownianMotion(x0=1.0, drift=0.3, diffusion=1.0, T=2.0, steps=8)
    s = w.terminal().sample(2048, random_state=1, method="antithetic").numpy()
    np.testing.assert_allclose(s.reshape(-1, 2).mean(axis=1), 1.6, atol=5e-5)


def test_sobol_beats_iid_on_the_terminal():
    g = pt.GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=16)
    s = g.terminal().sample(4096, random_state=0, method="sobol").numpy()
    iid_sem = 100 * np.exp(0.05) * 0.2 / np.sqrt(4096)
    assert abs(s.mean() - 100 * np.exp(0.05)) < 0.25 * iid_sem
