"""The port's joint multi-asset paths, on the CPU: ``CorrelatedGBM``,
``CorrelatedMerton`` (with the common jump stream, and with a zero-rate
asset) and ``CorrelatedHeston`` (and its common variance factor), through
their ``AssetPath`` views.

Each factory runs the battery of ``test_torch_processes.py``: quantile-mode
parity with the JAX package (the joint node's whole (n, d, steps) value,
within 1e-4 of each path's largest magnitude in float32 and 1e-9 in
float64; a row with a jump-count uniform within 4 ulps of a Poisson CDF
boundary is exempt, and there are none here), the terminal law in
``method=None`` mode (5 standard errors), ``d_total`` and its error, a
streamed Sobol run bitwise against one shot, ``copy()`` and the memo, and
the refusals.  Beside it: the closed-form log-terminal covariance, the
views' own API, ``_recolor_assets``'s unrolled order, and the LSMC hooks
(``_payoff_arity``, ``_state_paths_from_increments``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probabilit_tpu as jax_pkg
import probabilit_tpu_torch as pt
from probabilit_tpu.models import processes as jax_processes
from probabilit_tpu_torch import interop
from probabilit_tpu_torch.models.processes import AssetPath, _recolor_assets
from test_torch_processes import (  # noqa: F401  (the fixtures are used by name)
    Case,
    both_dtypes,
    check_parity,
    on_the_cpu,
    poisson_table,
    run_battery,
    within_se,
)
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

CORR2 = [[1.0, 0.6], [0.6, 1.0]]


def both_terminals(view, n, seed):
    """(n, 2) log-returns of the joint node's two assets, one draw."""
    a, b = AssetPath(view.joint, 0), AssetPath(view.joint, 1)
    pt.NoOp(a.terminal(), b.terminal()).sample(n, random_state=seed)
    s0 = view.joint.s0
    return np.stack([np.log(a.terminal().samples_.numpy() / s0[0]),
                     np.log(b.terminal().samples_.numpy() / s0[1])], axis=1).astype(np.float64)


def cov_within_se(x, i, j, want, label):
    """The sample covariance of columns i, j within 5 standard errors."""
    p = (x[:, i] - x[:, i].mean()) * (x[:, j] - x[:, j].mean())
    within_se(p, want, None, label)


def gbm_law(view, n, seed):
    x = both_terminals(view, n, seed)
    for i, (mu, sigma) in enumerate(((0.03, 0.2), (0.02, 0.3))):
        within_se(x[:, i], mu - sigma**2 / 2, sigma**2, f"cgbm {i}")
    cov_within_se(x, 0, 1, 0.6 * 0.2 * 0.3, "cgbm cov")


def merton_law_of(jump_rate, common_rate):
    mu, sigma, jm, js = np.array([0.03, 0.02]), np.array([0.2, 0.3]), -0.05, 0.1
    cm, cs, load = -0.1, 0.05, 1.0
    jr = np.asarray(jump_rate)
    mean = mu - sigma**2 / 2 + jr * jm + load * cm * common_rate
    var = sigma**2 + jr * (jm**2 + js**2) + load**2 * common_rate * (cm**2 + cs**2)
    cov = sigma[0] * sigma[1] * 0.5 + load * load * common_rate * (cm**2 + cs**2)

    def law(view, n, seed):
        x = both_terminals(view, n, seed)
        for i in range(2):
            within_se(x[:, i], mean[i], var[i], f"cmerton {i}")
        cov_within_se(x, 0, 1, cov, "cmerton cov")

    return law


def heston_law(view, n, seed):
    """Each asset's mean s0 e^{mu T} (the scheme's trapezoid bias is O(dt^2)
    and far inside 5 SE here) and the log-returns' positive correlation."""
    x = both_terminals(view, n, seed)
    for i in range(2):
        within_se(np.exp(x[:, i]), 1.0, None, f"cheston {i}")
    assert np.corrcoef(x.T)[0, 1] > 0.3


def merton_counts(node, slab):
    s, d = node.steps, node.d
    dt = node.T / s
    out = [(slab[:, (d + a) * s : (d + a + 1) * s], poisson_table(node.jump_rate[a] * dt))
           for a in range(d) if node.jump_rate[a] > 0]
    if node.common_rate > 0:
        out.append((slab[:, 3 * d * s : 3 * d * s + s], poisson_table(node.common_rate * dt)))
    return out


def merton(p, jump_rate, common_rate):
    return p.CorrelatedMerton(
        [100.0, 50.0], [0.03, 0.02], [0.2, 0.3], [[1, 0.5], [0.5, 1]], jump_rate=jump_rate,
        jump_mean=-0.05, common_rate=common_rate, common_mean=-0.1, common_std=0.05, steps=16,
    )[0]


def heston(p, var_corr):
    return p.CorrelatedHeston(
        [100.0, 50.0], [0.0, 0.0], v0=0.04, kappa=2.0, theta=0.04, sigma=0.3,
        rho=[-0.5, -0.3], corr=CORR2, steps=16, var_corr=var_corr,
    )[0]


CASES = {
    "correlated_gbm": Case(
        lambda p: p.CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3], CORR2, steps=16)[0],
        gbm_law),
    "correlated_merton_common": Case(
        lambda p: merton(p, [0.5, 1.0], 0.2), merton_law_of([0.5, 1.0], 0.2),
        count_uniforms=merton_counts),
    "correlated_merton_zero_rate": Case(
        lambda p: merton(p, [0.0, 0.7], 0.0), merton_law_of([0.0, 0.7], 0.0),
        count_uniforms=merton_counts),
    "correlated_heston": Case(lambda p: heston(p, 0.0), heston_law, newton=True),
}

run_battery(CASES, globals())


def test_common_variance_factor():
    """var_corr > 0: its extra slab block in float32 parity (the battery's
    float64 run of the JAX package's two chi-square solves compiles for
    about 8 s, so this case runs once), its terminal law, its width."""
    case = Case(lambda p: heston(p, 0.3), heston_law, newton=True)
    check_parity(case, np.float32)
    heston_law(case.build(pt), 1 << 16, 12)
    assert case.build(pt).joint._q_width == (3 * 2 + 1) * 16


def test_widths_follow_the_reference():
    for name, case in CASES.items():
        ref = case.build(jax_pkg).joint
        port = case.build(pt).joint
        assert port._q_width == ref._q_width, name
    assert CASES["correlated_merton_common"].build(pt).joint._q_width == 3 * 2 * 16 + 2 * 16


def test_recolor_keeps_the_unrolled_order(both_dtypes):
    """The port's chain against the JAX package's on the same drivers,
    bitwise (the same multiply-add order, zeros skipped; op by op, so
    nothing is contracted)."""
    chol = np.linalg.cholesky(np.array([[1, 0.5, 0.0], [0.5, 1, 0.3], [0.0, 0.3, 1]]))
    z = np.random.default_rng(0).standard_normal((64, 8, 3)).astype(both_dtypes)
    want = np.asarray(jax_processes._recolor_assets(jnp.asarray(z), chol))
    got = _recolor_assets(torch.from_numpy(z), chol).numpy()
    assert got.dtype == want.dtype == both_dtypes
    np.testing.assert_array_equal(got, want)


def test_views_and_the_joint_node():
    a, b = pt.CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3], CORR2, steps=8)
    assert a.joint is b.joint and (a.asset, b.asset) == (0, 1)
    assert a.terminal() is a.terminal() and a.terminal() is not b.terminal()
    with pytest.raises(TypeError, match="per-asset view"):
        a.joint.terminal()
    with pytest.raises(TypeError, match="PathDistribution"):
        pt.PathFunctional(a.joint, "max")
    joint = a.joint.sample(256, random_state=0)
    assert joint.shape == (256, 2, 8)
    pt.NoOp(a.maximum(), b.at(3)).sample(256, random_state=0)
    torch.testing.assert_close(a.maximum().samples_, a.joint.samples_[:, 0].amax(dim=1),
                               rtol=0, atol=0)
    torch.testing.assert_close(b.at(3).samples_, a.joint.samples_[:, 1, 3], rtol=0, atol=0)


def test_validation_matches_the_jax_package():
    for build, match in (
        (lambda p: p.CorrelatedGBM([100], [0.0], [0.2], [[1.0]]), "needs >= 2 assets"),
        (lambda p: p.CorrelatedGBM([100, 50], [0.0] * 3, [0.2, 0.2], CORR2), "equal lengths"),
        (lambda p: p.CorrelatedGBM([100, 50], 0.0, 0.2, [[1, 2], [2, 1]]), "positive definite"),
        (lambda p: p.CorrelatedMerton([100, 50], 0.0, 0.2, CORR2, jump_rate=-1.0), "jump_rate"),
        (lambda p: p.CorrelatedHeston([100, 50], 0.0, 0.04, 2.0, 0.04, 0.3, [-0.9, -0.9],
                                      [[1, 0.5], [0.5, 1]]), "infeasible"),
        (lambda p: p.CorrelatedHeston([100, 50], 0.0, 0.04, 2.0, 0.04, 0.3, -0.5, CORR2,
                                      var_corr=1.0), "var_corr"),
    ):
        for pkg in (jax_pkg, pt):
            with pytest.raises(ValueError, match=match):
                build(pkg)


def test_lsmc_hooks():
    a, _ = pt.CorrelatedHeston([100, 50], [0.0, 0.0], v0=0.04, kappa=2.0, theta=0.04,
                               sigma=0.3, rho=[-0.5, -0.3], corr=CORR2, steps=8)
    joint = a.joint
    assert joint._payoff_arity == 2
    assert joint._param_slots == ("s0[0]", "s0[1]", "mu[0]", "mu[1]", "v0[0]", "v0[1]")
    gen = torch.Generator().manual_seed(0)
    inc = joint._increments(gen, 128, torch.float32)
    assert inc.shape == (128, 8, 3, 2)
    states = joint._state_paths_from_increments(inc)
    assert len(states) == 4 and all(s.shape == (128, 8) for s in states)
    paths = joint._path_from_increments(inc)
    torch.testing.assert_close(states[1], paths[:, 1], rtol=0, atol=0)
    assert bool((states[2] > 0).all() and (states[3] > 0).all())


def test_from_reference_maps_views_onto_the_mapped_joint():
    ra, rb = jax_pkg.CorrelatedMerton([100.0, 50.0], [0.03, 0.02], [0.2, 0.3],
                                      [[1, 0.5], [0.5, 1]], jump_rate=[0.5, 1.0],
                                      common_rate=0.2, common_mean=-0.1, common_std=0.05,
                                      steps=4)
    ref = 0.5 * ra.terminal() + 0.5 * rb.maximum()
    mapping = interop.from_reference(ref)
    a, b = mapping[ra._id], mapping[rb._id]
    assert a.joint is b.joint is mapping[ra.joint._id]
    assert (a.asset, b.asset) == (0, 1)
    for key in ("s0", "mu", "sigma", "jump_rate", "jump_mean", "jump_std", "loadings", "corr"):
        np.testing.assert_array_equal(getattr(a.joint, key), getattr(ra.joint, key))
    assert a.joint._static_signature() == ra.joint._static_signature()
    assert mapping[rb.maximum()._id] is b.maximum()
