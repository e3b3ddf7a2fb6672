"""The port's generic SDE node (Euler and Milstein) and its Markov-chain
families (``MarkovChain``, ``RegimeSwitchingGBM``), on the CPU.

Each factory runs the battery of ``test_torch_processes.py``: quantile-mode
parity with the JAX package (within 1e-4 of each path's largest magnitude
in float32, 1e-9 in float64; the chain's states equal, a row with a chain
uniform within 4 ulps of a cumulative transition probability exempt, and
there are none here), the terminal law in ``method=None`` mode (5
standard errors against the discrete schemes' own closed forms), ``d_total``
and its error, a streamed Sobol run bitwise against one shot, ``copy()``
and the memo, and the refusals.  The SDE's callables use operators only,
so the same functions run on jnp arrays and on torch tensors.  Beside it:
Milstein with a constant diffusion equals Euler bitwise, a constant
callable broadcasts, the chain's gather equals the JAX package's one-hot
product state for state, and the chain's law at an intermediate step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probabilit_tpu as jax_pkg
import probabilit_tpu_torch as pt
from probabilit_tpu.models import markov as jax_markov
from probabilit_tpu_torch.models import markov
from test_torch_processes import (  # noqa: F401  (the fixtures are used by name)
    SE,
    Case,
    both_dtypes,
    on_the_cpu,
    quantiles,
    run_battery,
    within_se,
)
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

STEPS = 16
P3 = [[0.8, 0.15, 0.05], [0.1, 0.8, 0.1], [0.05, 0.15, 0.8]]
VALUES3 = [1.0, 2.0, 5.0]
P2 = [[0.95, 0.05], [0.1, 0.9]]
MU2, SIGMA2 = [0.08, -0.02], [0.15, 0.4]


def ou_drift(t, x):
    return 1.5 * (0.5 - x)


def ou_diffusion(t, x):
    return 0.3


def gbm_drift(t, x):
    return 0.05 * x


def gbm_diffusion(t, x):
    return 0.2 * x


def euler_law(sde, n, seed):
    """The Euler scheme of a linear drift is an AR(1): mean 0.5 + 1.5 r^k,
    variance by the recursion v' = r^2 v + b^2 dt, r = 1 - 1.5 dt."""
    dt = 1.0 / STEPS
    r = 1.0 - 1.5 * dt
    v = 0.0
    for _ in range(STEPS):
        v = r * r * v + 0.09 * dt
    x = sde.terminal().sample(n, random_state=seed).numpy()
    within_se(x, 0.5 + 1.5 * r**STEPS, v, "euler")


def milstein_law(sde, n, seed):
    """Milstein on dX = mu X dt + s X dW multiplies by 1 + mu dt + s sqrt(dt) z
    + s^2 dt (z^2 - 1) / 2 a step: mean (1 + mu dt)^k, second moment
    ((1 + mu dt)^2 + s^2 dt + s^4 dt^2 / 2)^k."""
    dt = 1.0 / STEPS
    m1 = 1.0 + 0.05 * dt
    m2 = m1**2 + 0.04 * dt + 0.5 * 0.2**4 * dt * dt
    x = sde.terminal().sample(n, random_state=seed).numpy()
    within_se(x, 100 * m1**STEPS, 1e4 * (m2**STEPS - m1 ** (2 * STEPS)), "milstein")


def chain_law(chain, n, seed):
    p = np.linalg.matrix_power(np.array(P3), STEPS)[0]
    v = np.array(VALUES3)
    mean = p @ v
    x = chain.terminal().sample(n, random_state=seed).numpy()
    within_se(x, mean, p @ v**2 - mean**2, "chain")
    counts = np.bincount(np.searchsorted(v, x), minlength=3) / n
    assert np.all(np.abs(counts - p) <= SE * np.sqrt(p * (1 - p) / n)), (counts, p)


def regime_law(rs, n, seed):
    """E[S_T^m] = s0^m e_x0 (D P)^(k-1) D 1, D = diag(E[exp(m dlog)])."""
    dt = 1.0 / STEPS
    P = np.array(P2)
    mu, sd = np.array(MU2), np.array(SIGMA2)

    def moment(m):
        D = np.diag(np.exp(m * mu * dt + 0.5 * m * (m - 1) * sd**2 * dt))
        return 100.0**m * (np.linalg.matrix_power(D @ P, STEPS - 1) @ D @ np.ones(2))[0]

    x = rs.terminal().sample(n, random_state=seed).numpy()
    within_se(x, moment(1), moment(2) - moment(1) ** 2, "regime")


def chain_uniforms(node, slab):
    return [(slab[:, : node.steps], np.unique(node._cum))]


CASES = {
    "sde_euler": Case(
        lambda p: p.SDE(ou_drift, ou_diffusion, x0=2.0, T=1.0, steps=STEPS), euler_law),
    "sde_milstein": Case(
        lambda p: p.SDE(gbm_drift, gbm_diffusion, x0=100.0, T=1.0, steps=STEPS,
                        scheme="milstein"), milstein_law),
    "markov_chain": Case(
        lambda p: p.MarkovChain(P3, x0=0, values=VALUES3, steps=STEPS), chain_law,
        count_uniforms=chain_uniforms),
    "regime_switching_gbm": Case(
        lambda p: p.RegimeSwitchingGBM(100.0, MU2, SIGMA2, P2, x0_state=0, steps=STEPS),
        regime_law, count_uniforms=chain_uniforms),
}

run_battery(CASES, globals())


def test_milstein_with_a_constant_diffusion_is_euler():
    q = torch.from_numpy(quantiles(1024, STEPS, 3)).float()
    e = pt.SDE(ou_drift, ou_diffusion, x0=2.0, steps=STEPS)
    m = pt.SDE(ou_drift, ou_diffusion, x0=2.0, steps=STEPS, scheme="milstein")
    torch.testing.assert_close(m.sample_from_quantiles(q), e.sample_from_quantiles(q),
                               rtol=0, atol=0)


def test_callables_see_the_left_endpoint_and_may_return_constants():
    seen = []

    def drift(t, x):
        seen.append(float(t))
        return torch.zeros_like(x)

    sde = pt.SDE(drift, lambda t, x: 1.0, steps=4, T=2.0)
    x = sde.sample(512, random_state=0)
    assert seen == [0.0, 0.5, 1.0, 1.5] and x.shape == (512, 4)
    within_se(x[:, -1].numpy(), 0.0, None, "brownian by sde")
    with pytest.raises(TypeError, match="callable"):
        pt.SDE(1.0, ou_diffusion)
    with pytest.raises(ValueError, match="scheme"):
        pt.SDE(ou_drift, ou_diffusion, scheme="rk4")


def test_regrid_and_hooks():
    sde = pt.SDE(gbm_drift, gbm_diffusion, x0=100.0, steps=8, scheme="milstein")
    fine = sde._regrid(16)
    assert (fine.steps, fine.scheme, fine.drift, fine.x0) == (16, "milstein", gbm_drift, 100.0)
    z = torch.randn(4, 8)
    assert sde._increments_from_normals(z, torch.float32) is z
    assert sde._param_slots == ()


def test_chain_gather_equals_the_one_hot_product(both_dtypes):
    """The port's gather of the current state's cumulative row against the
    JAX package's one-hot product, state for state, on uniforms placed on
    and beside every boundary."""
    cum = np.cumsum(np.array(P3), axis=1)
    u = quantiles(4096, 12, 5)
    edges = np.unique(cum.astype(both_dtypes))
    u[:64, 0] = np.repeat(edges, 64 // len(edges) + 1)[:64]
    u[64:128, 1] = np.nextafter(u[:64, 0].astype(both_dtypes), 0)
    u = u.astype(both_dtypes)
    dtype = jnp.float32 if both_dtypes == np.float32 else jnp.float64
    want = np.asarray(jax_markov._chain_scan(jnp.asarray(u), cum, 1, dtype))
    got = markov._chain_scan(torch.from_numpy(u), cum, 1).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_chain_law_at_an_intermediate_step():
    chain = pt.MarkovChain(P3, x0=2, steps=8)
    x = chain.at(3).sample(1 << 15, random_state=9).numpy()
    p = np.linalg.matrix_power(np.array(P3), 4)[2]
    counts = np.bincount(x.astype(int), minlength=3) / x.size
    assert np.all(np.abs(counts - p) <= SE * np.sqrt(p * (1 - p) / x.size)), (counts, p)


def test_validation_matches_the_jax_package():
    for build, match in (
        (lambda p: p.MarkovChain([[0.5, 0.6], [0.5, 0.5]]), "sum to 1"),
        (lambda p: p.MarkovChain([[1.0]]), "at least 2 states"),
        (lambda p: p.MarkovChain(P2, x0=2), "x0 must be a state index"),
        (lambda p: p.MarkovChain(P2, values=[1.0]), "values must have shape"),
        (lambda p: p.RegimeSwitchingGBM(100, [0.1], SIGMA2, P2), "mu and sigma"),
        (lambda p: p.RegimeSwitchingGBM(100, MU2, [0.1, 0.0], P2), "sigma must be positive"),
    ):
        for pkg in (jax_pkg, pt):
            with pytest.raises(ValueError, match=match):
                build(pkg)
