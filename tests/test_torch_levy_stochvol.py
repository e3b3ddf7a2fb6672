"""The port's Lévy and square-root-diffusion paths, on the CPU: Variance
Gamma, Normal Inverse Gaussian, Cox-Ingersoll-Ross and Heston.

Each factory runs the battery of ``test_torch_processes.py``: quantile-mode
parity with the JAX package on uniforms in [0.001, 0.999] (every factory
here runs a Newton ppf: gamma, invgauss, chi2), within 1e-4 of each path's
largest magnitude in float32 and 1e-9 in float64; the terminal law in
``method=None`` mode (5 standard errors against the closed forms);
``d_total`` and its error; a streamed Sobol run bitwise against one shot;
``copy()`` and the memo; the refusals.  Beside it: Heston's state pair
(its variance is the CIR path of the same drivers, bitwise) and CIR's
intermediate slice against the noncentral chi-square transition.  The
JAX package's own ``tests/test_levy_stochvol.py`` runs at far larger
sizes; these stay at 2^12 paths x 16 steps where the JAX package runs.
"""

import numpy as np
import pytest
import scipy.stats as sps
import torch

import probabilit_tpu as jax_pkg
import probabilit_tpu_torch as pt
from test_torch_processes import (  # noqa: F401  (the fixtures are used by name)
    Case,
    both_dtypes,
    on_the_cpu,
    run_battery,
    within_se,
)
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

STEPS = 16


def vg_law(vg, n, seed):
    x = vg.terminal().sample(n, random_state=seed).numpy()
    within_se(x, (0.1 - 0.2) * 2.0, (0.3**2 + 0.25 * 0.2**2) * 2.0, "vg")


def nig_law(nig, n, seed):
    alpha, beta, delta, mu, T = 2.0, -0.5, 0.8, 0.1, 1.5
    g = np.sqrt(alpha**2 - beta**2)
    x = nig.terminal().sample(n, random_state=seed).numpy()
    within_se(x, (mu + delta * beta / g) * T, delta * alpha**2 / g**3 * T, "nig")


def cir_moments(v0, kappa, theta, sigma, t):
    e = np.exp(-kappa * t)
    mean = theta + (v0 - theta) * e
    var = v0 * sigma**2 * e * (1 - e) / kappa + theta * sigma**2 * (1 - e) ** 2 / (2 * kappa)
    return mean, var


def cir_law(cir, n, seed):
    x = cir.terminal().sample(n, random_state=seed).numpy()
    within_se(x, *cir_moments(0.03, 2.0, 0.04, 0.3, 1.0), "cir")


def heston_law(h, n, seed):
    """The asset's mean s0 e^{mu T} (the trapezoid's O(dt^2) bias is far
    inside 5 SE here)."""
    x = h.terminal().sample(n, random_state=seed).numpy()
    within_se(x, 100 * np.exp(0.04), None, "heston")


CASES = {
    "variance_gamma": Case(
        lambda p: p.VarianceGamma(mu=0.1, theta=-0.2, sigma=0.3, nu=0.25, T=2.0, steps=STEPS),
        vg_law, newton=True),
    "normal_inverse_gaussian": Case(
        lambda p: p.NormalInverseGaussian(alpha=2.0, beta=-0.5, delta=0.8, mu=0.1, T=1.5,
                                          steps=STEPS), nig_law, newton=True),
    "cox_ingersoll_ross": Case(
        lambda p: p.CoxIngersollRoss(v0=0.03, kappa=2.0, theta=0.04, sigma=0.3, steps=STEPS),
        cir_law, newton=True),
    "heston": Case(
        lambda p: p.Heston(s0=100, mu=0.04, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3,
                           rho=-0.7, steps=STEPS), heston_law, newton=True),
}

run_battery(CASES, globals())


def test_heston_variance_is_the_cir_path_of_its_drivers():
    h = pt.Heston(s0=100, mu=0.04, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, steps=8)
    cir = pt.CoxIngersollRoss(v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, steps=8)
    inc = h._increments(torch.Generator().manual_seed(1), 512, torch.float32)
    asset, variance = h._state_paths_from_increments(inc)
    torch.testing.assert_close(variance, cir._path_from_increments(inc[:, :, 1:]), rtol=0, atol=0)
    torch.testing.assert_close(asset, h._path_from_increments(inc), rtol=0, atol=0)
    assert h._param_slots == ("s0", "mu", "rho", "v0") and cir._param_slots == ("v0",)


def test_cir_slice_matches_the_transition_law():
    """at(k) ~ c_k ncx2(df, v0 e_k / c_k) with the one-step constants
    composed to t_k (KS at 2^14, as the JAX package's test)."""
    v0, kappa, theta, sigma, T = 0.03, 2.0, 0.04, 0.3, 1.0
    cir = pt.CoxIngersollRoss(v0=v0, kappa=kappa, theta=theta, sigma=sigma, T=T, steps=8)
    t = 4 * T / 8
    e = np.exp(-kappa * t)
    c = sigma**2 * (1 - e) / (4 * kappa)
    df = 4 * kappa * theta / sigma**2
    x = cir.at(3).sample(1 << 14, random_state=2).numpy().astype(np.float64)
    assert sps.kstest(x / c, sps.ncx2(df, v0 * e / c).cdf).pvalue > 1e-3


def test_validation_matches_the_jax_package():
    for build, match in (
        (lambda p: p.VarianceGamma(nu=0.0), "nu"),
        (lambda p: p.NormalInverseGaussian(alpha=1.0, beta=1.0), "beta"),
        (lambda p: p.CoxIngersollRoss(v0=0.04, kappa=0.1, theta=0.04, sigma=0.5), "> 1"),
        (lambda p: p.Heston(rho=1.0), "rho"),
    ):
        for pkg in (jax_pkg, pt):
            with pytest.raises(ValueError, match=match):
                build(pkg)
