"""Every path family's gradients against the JAX package's, on the CPU.

Each factory whose node declares differentiable slots (Brownian, GBM, OU,
Merton, the joint GBM, Merton and Heston, VG, NIG, CIR, Heston) at 8
steps: the terminal's mean and variance and their gradients with respect
to every slot, on one explicit slab of 2^10 rows (uniforms in [0.001,
0.999]: VG's, NIG's and CIR's drivers run a Newton ppf), the JAX
package's ``value_and_grad`` over its own ``build_body`` against the
port's ``_build_grad_fn`` (``test_torch_sensitivity.py``'s helpers and
tolerances: 1e-5 / 1e-4 in float32, 1e-11 / 1e-9 in float64).  Float32
for every family, float64 for the joint Merton (14 indexed slots); the
measured agreement is about 6e-7 and 1e-15.
"""

import numpy as np
import pytest

import probabilit_tpu as jax_pkg
from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import sensitivity as jax_sens
from probabilit_tpu_torch import interop
from test_torch_sensitivity import (  # noqa: F401  (the fixtures are used by name)
    _assert_parity,
    _jax_value_and_grad,
    _port_value_and_grad,
    both_dtypes,
    on_the_cpu,
    vector_math_initialised,
)
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

STEPS = 8
CORR = [[1.0, 0.6], [0.6, 1.0]]
FAMILIES = {
    "brownian": lambda: jax_pkg.BrownianMotion(x0=1.0, drift=0.3, diffusion=1.5, T=2.0,
                                               steps=STEPS),
    "gbm": lambda: jax_pkg.GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=STEPS),
    "ou": lambda: jax_pkg.OrnsteinUhlenbeck(x0=2.0, theta=1.5, mu=0.5, sigma=0.8, steps=STEPS),
    "merton": lambda: jax_pkg.MertonJumpDiffusion(s0=100, mu=0.03, sigma=0.2, jump_rate=1.0,
                                                  jump_mean=-0.05, jump_std=0.1, steps=STEPS),
    "correlated_gbm": lambda: jax_pkg.CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3], CORR,
                                                    steps=STEPS)[0],
    "correlated_merton": lambda: jax_pkg.CorrelatedMerton(
        [100.0, 50.0], [0.03, 0.02], [0.2, 0.3], [[1, 0.5], [0.5, 1]], jump_rate=[0.5, 1.0],
        jump_mean=-0.05, common_rate=0.2, common_mean=-0.1, common_std=0.05, steps=STEPS)[0],
    "variance_gamma": lambda: jax_pkg.VarianceGamma(mu=0.1, theta=-0.2, sigma=0.3, nu=0.25,
                                                    T=2.0, steps=STEPS),
    "normal_inverse_gaussian": lambda: jax_pkg.NormalInverseGaussian(
        alpha=2.0, beta=-0.5, delta=0.8, mu=0.1, T=1.5, steps=STEPS),
    "cox_ingersoll_ross": lambda: jax_pkg.CoxIngersollRoss(v0=0.03, kappa=2.0, theta=0.04,
                                                           sigma=0.3, steps=STEPS),
    "heston": lambda: jax_pkg.Heston(s0=100, mu=0.04, v0=0.04, kappa=2.0, theta=0.04,
                                     sigma=0.3, rho=-0.7, steps=STEPS),
    "correlated_heston": lambda: jax_pkg.CorrelatedHeston(
        [100.0, 50.0], [0.0, 0.0], v0=0.04, kappa=2.0, theta=0.04, sigma=0.3,
        rho=[-0.5, -0.3], corr=CORR, steps=STEPS)[0],
}
CASES = [(name, "float32") for name in FAMILIES] + [("correlated_merton", "float64")]


@pytest.mark.parametrize("name,both_dtypes", CASES, indirect=["both_dtypes"],
                         ids=[f"{n}-{d}" for n, d in CASES])
def test_path_family_gradients_match_jax(name, both_dtypes):
    surface = FAMILIES[name]()
    node = getattr(surface, "joint", surface)
    sink = surface.terminal()
    pairs = [(node, slot) for slot in jax_sens._numeric_slots(node)]
    assert pairs, name
    width = jax_compile.get_plan(sink).d_total
    q = 0.001 + 0.998 * np.random.default_rng(1).integers(1, 2**23, (1 << 10, width)) / 2**23
    ref = _jax_value_and_grad(sink, pairs, ["mean", "var"], q, False)
    mapping = interop.from_reference(sink)
    port_pairs = [(mapping[node._id], slot) for _, slot in pairs]
    for statistic in ("mean", "var"):
        got = _port_value_and_grad(mapping[sink._id], port_pairs, statistic, q, False)
        _assert_parity(ref[statistic], got, both_dtypes)
