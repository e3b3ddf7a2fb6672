"""The port's multilevel Monte Carlo (``engine/mlmc.py``) on the CPU.

The level function's four sums (sum d, sum d^2, sum P_f, sum P_f^2) on
one given normal matrix against the JAX package's hooks on the same
matrix: the fine path is ``_path_from_increments(_increments_from_normals
(z))`` of the JAX package's node, the coarse path the same of the
reshape-sum of ``z`` over sqrt(refine), for Euler and Milstein ``SDE``s
and for GBM and OU on their exact laws, levels 1 and 2 (OU at level 1;
level 0 for Euler and GBM), in float32, within
1e-5 of max(1, |sum|) (the packages' float32 steps and scans round apart;
the port sums in float64, the test sums the JAX package's float32 values
in float64).  Then: MLQMC's Sobol points bitwise against the JAX
package's under the same Owen seeds and their bridged normals within
1e-5 of the largest magnitude (the bridge's parity), a deterministic
coupling against its quadrature difference, the ``SDE`` node equal to
the callable API, a GBM terminal payoff's corrections 0 to float32
rounding on the exact law (variance below 1e-8, the JAX package's
bound), the GBM call within 3 eps of e^{rT} BS at eps = 0.15, and the
validation messages against the JAX package's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probabilit_tpu as jax_pkg
from probabilit_tpu import config as jax_config
from probabilit_tpu.engine import mlmc as jax_mlmc
from probabilit_tpu.models import sde as jax_sde
from probabilit_tpu.ops import bridge as jax_bridge
from probabilit_tpu.ops import qmc as jax_qmc
import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import cuda_exec, mlmc
from probabilit_tpu_torch.ops import qmc
from test_torch_graph import vector_math_initialised  # noqa: F401  (autouse)

SUM_TOL = 1e-5
ROWS = 256
CALL_TRUE = 10.4506 * math.exp(0.05)  # e^{rT} x Black-Scholes(100, 100, 0.2, 1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _drift(t, x):
    return 0.05 * x


def _diffusion(t, x):
    return 0.2 * x


def _asian_jax(p):
    return jnp.maximum(jnp.mean(p, axis=1) - 100.0, 0.0)


def _asian_torch(p):
    return torch.clamp(p.mean(dim=1) - 100.0, min=0.0)


def _call_torch(p):
    return torch.clamp(p[:, -1] - 100.0, min=0.0)


def _call_jax(p):
    return jnp.maximum(p[:, -1] - 100.0, 0.0)


FAMILIES = {
    "euler": (lambda: jax_sde.SDEPath(_drift, _diffusion, x0=100.0, T=1.0, steps=4,
                                      scheme="euler"), _asian_jax, _asian_torch),
    "milstein": (lambda: jax_sde.SDEPath(_drift, _diffusion, x0=100.0, T=1.0, steps=4,
                                         scheme="milstein"), _asian_jax, _asian_torch),
    "gbm": (lambda: jax_pkg.GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, steps=4),
            _asian_jax, _asian_torch),
    "ou": (lambda: jax_pkg.OrnsteinUhlenbeck(x0=2.0, theta=1.5, mu=0.5, sigma=0.3, steps=4),
           lambda p: jnp.mean(p, axis=1), lambda p: p.mean(dim=1)),
}


def _jax_sums(node, payoff, level, z):
    """The four sums from the JAX package's own hooks on ``z``."""
    steps = 4 * 4**level
    dtype = jax_config.float_dtype()
    zj = jnp.asarray(z, dtype)

    def pay(grid, drivers):
        path = node._regrid(grid)
        return np.asarray(payoff(path._path_from_increments(
            path._increments_from_normals(drivers, dtype))), np.float64)

    pf = pay(steps, zj)
    d = pf
    if level:
        zc = zj.reshape(zj.shape[0], steps // 4, 4).sum(axis=2) * (1.0 / math.sqrt(4))
        d = pf - pay(steps // 4, zc)
    return np.array([d.sum(), (d * d).sum(), pf.sum(), (pf * pf).sum()])


# Levels 1 and 2 run both grids of each family (OU's scan, whose JAX
# compile is the file's slowest, at level 1 only); level 0 (the fine grid
# alone) runs for one scheme and one exact law.
LEVEL_CASES = [(f, lv) for f in ("euler", "gbm", "milstein") for lv in (1, 2)] + [
    ("ou", 1), ("euler", 0), ("gbm", 0)]


@pytest.mark.parametrize("family,level", LEVEL_CASES)
def test_level_sums_match_the_jax_hooks(family, level):
    make, pay_jax, pay_torch = FAMILIES[family]
    node = make()
    z = np.random.default_rng(10 * level + len(family)).standard_normal(
        (ROWS, 4 * 4**level)).astype(np.float32)
    want = _jax_sums(node, pay_jax, level, z)
    port_node = interop.from_reference(node)[node._id]
    _, sums, steps = mlmc._level_kernel(port_node._regrid, pay_torch, 4, 4, level)
    got = sums(torch.from_numpy(z)).numpy()
    assert steps == 4 * 4**level and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=SUM_TOL, atol=SUM_TOL)


def _owen_seeds(key, d):
    """The JAX package's Sobol scramble seeds under ``key``."""
    seeds = jax.random.randint(key, (d,), 0, np.iinfo(np.int32).max, dtype=jnp.int32)
    return np.asarray(seeds.astype(jnp.uint32)).astype(np.int64)


@pytest.mark.parametrize("level,start", [(2, 12345)])
def test_mlqmc_bridged_normals_match_jax(level, start, monkeypatch):
    """The level's Sobol draw under the JAX package's Owen seeds: the
    points bitwise, their bridged normals as the bridge's parity."""
    steps = 4 * 4**level
    key = jax.random.PRNGKey(level)
    seeds = _owen_seeds(key, steps)
    points = np.asarray(jax_qmc.sobol(key, 300, steps, offset=start))
    np.testing.assert_array_equal(qmc.sobol(seeds, 300, steps, offset=start).numpy(), points)
    monkeypatch.setattr(qmc, "randomisation", lambda name, seed, d, dtype=None: seeds)
    draw, _, _ = mlmc._level_kernel(
        lambda s: pt.GeometricBrownianMotion(s0=1.0, mu=0.0, sigma=1.0, steps=s), _call_torch,
        4, 4, level, method="sobol")
    got = draw(0, 300, start).numpy()
    want = np.asarray(jax_bridge.normal_increments(jnp.asarray(points), jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_deterministic_coupling_is_the_quadrature_difference():
    """Zero diffusion: the correction is the two grids' Euler sums of cos."""
    def make(steps):
        return pt.SDE(lambda t, x: torch.cos(t), lambda t, x: 0.0, x0=0.0, T=1.0, steps=steps)

    draw, sums, _ = mlmc._level_kernel(make, lambda p: p[:, -1], 4, 4, 1)
    s1 = float(sums(draw(0, 64, 0))[0])
    dt_f, dt_c = 1 / 16, 1 / 4
    want = np.cos(dt_f * np.arange(16)).sum() * dt_f - np.cos(dt_c * np.arange(4)).sum() * dt_c
    assert s1 / 64 == pytest.approx(want, abs=1e-6)


def test_gbm_call_within_eps_and_the_sde_node_matches_the_callables():
    before = cuda_exec.LAUNCHES
    res = pt.mlmc_estimate(_drift, _diffusion, _call_torch, x0=100.0, eps=0.15, random_state=0)
    assert abs(res["mean"] - CALL_TRUE) < 3 * 0.15
    assert res["levels"] >= 2 and res["cost"] < res["cost_mc"]
    assert len(res["n_per_level"]) == len(res["steps"]) == res["levels"]
    assert res["steps"] == [4 * 4**lv for lv in range(res["levels"])]
    node = pt.SDE(_drift, _diffusion, x0=100.0, T=1.0, steps=999)
    same = pt.mlmc_estimate(node, _call_torch, eps=0.15, random_state=0)
    assert same["mean"] == res["mean"] and same["n_per_level"] == res["n_per_level"]
    assert cuda_exec.LAUNCHES == before


def test_exact_law_terminal_corrections_vanish():
    gbm = pt.GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, T=1.0, steps=4)
    res = pt.mlmc_estimate(gbm, _call_torch, eps=0.2, random_state=1)
    assert res["variances"][1] < 1e-8 and abs(res["means"][1]) < 1e-4
    assert abs(res["mean"] - CALL_TRUE) < 3 * 0.2


def test_milstein_corrections_fall_faster_than_euler():
    """At refine 4 Euler's correction variance falls ~4x a level, Milstein's
    ~16x: level 1 against level 2 on 2^14 paths each."""
    def level_var(scheme, level, seed):
        def make(steps):
            return pt.SDE(_drift, _diffusion, x0=100.0, T=1.0, steps=steps, scheme=scheme)

        draw, sums, _ = mlmc._level_kernel(make, _call_torch, 4, 4, level)
        s1, s2, _, _ = sums(draw(seed, 1 << 14, 0)).tolist()
        n = float(1 << 14)
        return s2 / n - (s1 / n) ** 2

    e1, e2 = level_var("euler", 1, 10), level_var("euler", 2, 11)
    m1, m2 = level_var("milstein", 1, 12), level_var("milstein", 2, 13)
    assert 2.0 < e1 / e2 < 9.0 and m1 / m2 > 6.0 and m1 < 0.25 * e1


def _validation_cases(pkg, call):
    gbm = pkg.GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, steps=4)
    merton = pkg.MertonJumpDiffusion(s0=100.0, steps=4)
    est = jax_mlmc.mlmc_estimate if pkg is jax_pkg else mlmc.mlmc_estimate
    cb = dict(x0=100.0)
    return {
        "eps": lambda: est(_drift, _diffusion, call, eps=0.0, **cb),
        "refine": lambda: est(_drift, _diffusion, call, refine=1, **cb),
        "m0": lambda: est(_drift, _diffusion, call, m0=0, **cb),
        "max_levels": lambda: est(_drift, _diffusion, call, max_levels=1, **cb),
        "lhs": lambda: est(_drift, _diffusion, call, method="lhs", **cb),
        "method": lambda: est(_drift, _diffusion, call, method="qmc", **cb),
        "missing_x0": lambda: est(_drift, _diffusion, call),
        "missing_payoff": lambda: est(gbm),
        "x0_with_node": lambda: est(gbm, call, x0=1.0),
        "no_grid_refinement": lambda: est(merton, call, eps=0.1),
    }


@pytest.mark.parametrize("case", sorted(_validation_cases(pt, _call_torch)))
def test_validation_matches_jax(case):
    caught = []
    for pkg, call in ((jax_pkg, _call_jax), (pt, _call_torch)):
        with pytest.raises((ValueError, NotImplementedError)) as info:
            _validation_cases(pkg, call)[case]()
        caught.append((info.type, str(info.value)))
    assert caught[1] == caught[0]
