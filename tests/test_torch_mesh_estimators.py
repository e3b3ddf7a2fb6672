"""The port's estimators under a device mesh, on the CPU.

Each case follows the JAX package's own mesh test of the same case, with
the port under a mesh of ``[cpu] * n_dev`` against the port without one:

* bitwise, as the JAX tests assert: a fixed-size streamed ``estimate``
  (moments, quantiles, CVaR, histogram; iid, Sobol and correlated),
  ``estimate_many``, ``sample_streaming``, a copula
  (``test_copulas.py:153``), path factories in key mode
  (``test_processes.py``: GBM, OU) and a Sobol path;
* ``mlmc_estimate`` (``test_mlmc.py:204``): the same levels and samples
  per level, the mean within 1e-4 relative (each shard's float64 sums are
  added on the first device);
* ``american_price`` (``test_american.py:316``, 2^12 paths, 10 dates):
  the price within 3 SE and an exercise fraction in (0, 1).  The Gram
  sums are the shards' partial products, so, with the float32 backward
  induction, the fit is held at its first solve (within 1e-4 of the
  largest weight) and one policy applied under the mesh equals the
  policy without it bitwise; the two fits are not compared path by path;
* ``sobol_indices`` (``test_sensitivity.py:568``) within 1e-5 absolute,
  ``sensitivity`` (single-shot and streamed) within 1e-5 relative (the
  gradient is summed over the shards), ``sweep`` under common random
  numbers bitwise (its row statistics run on the gathered rows).
"""

import math

import numpy as np
import pytest
import torch

import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import american
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.parallel import make_mesh, set_mesh, use_mesh
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)
        set_mesh(None)


def _under(n_dev, fn):
    with use_mesh(make_mesh([CPU] * n_dev)):
        return fn()


def _same(a, b):
    """Bitwise equal nested results (dicts of floats and arrays)."""
    assert repr(a) == repr(b)


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("method", [None, "sobol"])
def test_fixed_size_estimate_is_bitwise(n_dev, method):
    sink = benchmarks.mixed_dag_20()
    kw = dict(block_size=2**12, random_state=0, quantiles=(0.5, 0.99), cvar=(0.99,),
              histogram=(-2e4, 1.5e5, 50), method=method)
    base = pt.estimate(sink, 2**14, **kw)
    _same(base, _under(n_dev, lambda: pt.estimate(sink, 2**14, **kw)))


def test_correlated_estimate_is_bitwise():
    # Each block's sort-free recolouring runs on the first device.
    sink = benchmarks.mixed_correlated_50()
    kw = dict(block_size=2**12, random_state=1, quantiles=(0.9,))
    _same(pt.estimate(sink, 2**14, **kw), _under(4, lambda: pt.estimate(sink, 2**14, **kw)))


def test_estimate_many_and_streaming_are_bitwise():
    x = pt.Distribution("norm")
    y = 2.0 * x + pt.Distribution("expon")
    kw = dict(block_size=2**12, random_state=0, quantiles=(0.5,), covariance=True)
    base = pt.estimate_many([x, y], 2**14, **kw)
    sharded = _under(4, lambda: pt.estimate_many([x, y], 2**14, **kw))
    for node in (x, y):
        _same(base[node], sharded[node])
    s0 = pt.sample_streaming(y, 10_000, block_size=2**12, random_state=2)
    np.testing.assert_array_equal(
        s0, _under(8, lambda: pt.sample_streaming(y, 10_000, block_size=2**12, random_state=2))
    )


@pytest.mark.parametrize("n_dev", [2, 8])
def test_copula_is_bitwise(n_dev):
    u1, u2 = pt.ClaytonCopula(theta=2.0)
    model = pt.QuantileTransform(u1, "norm") + pt.QuantileTransform(u2, "expon")
    base = model.sample(4096, random_state=3).numpy()
    np.testing.assert_array_equal(base, _under(n_dev, lambda: model.sample(4096, random_state=3)))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_path_factories_key_mode_and_sobol_are_bitwise(n_dev):
    g = pt.GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, steps=32)
    payoff = (g.maximum() < 130) * (g.terminal() - 100)
    ou = pt.OrnsteinUhlenbeck(theta=2.0, sigma=0.3, steps=32)
    expr = ou.average() + ou.terminal()
    for node, method in ((payoff, None), (expr, None), (payoff, "sobol")):
        base = node.sample(4096, random_state=3, method=method).numpy()
        got = _under(n_dev, lambda: node.sample(4096, random_state=3, method=method))
        np.testing.assert_array_equal(base, got.numpy())


def test_mlmc_matches_single_device():
    def payoff(paths):
        return torch.clamp(paths[:, -1] - 100.0, min=0.0)

    kw = dict(x0=100.0, eps=0.2, random_state=0)
    drift, diff = (lambda t, x: 0.05 * x), (lambda t, x: 0.2 * x)
    base = pt.mlmc_estimate(drift, diff, payoff, **kw)
    sharded = _under(4, lambda: pt.mlmc_estimate(drift, diff, payoff, **kw))
    assert sharded["n_per_level"] == base["n_per_level"]
    assert sharded["mean"] == pytest.approx(base["mean"], rel=1e-4)


def _put(strike):
    return lambda s: torch.clamp(strike - s, min=0.0)


def test_american_matches_single_device():
    gbm = pt.GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, T=1.0, steps=10)
    base = american.american_price(gbm, _put(40.0), rate=0.06, size=1 << 12, random_state=0)
    sharded = _under(4, lambda: american.american_price(
        gbm, _put(40.0), rate=0.06, size=1 << 12, random_state=0))
    assert sharded["price"] == pytest.approx(base["price"], abs=3 * base["se"])
    assert 0.0 < sharded["exercise_fraction"] < 1.0


@pytest.mark.parametrize("n_dev", [2, 8])
def test_american_first_solve_and_one_policy(n_dev):
    gbm = pt.GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, T=1.0, steps=10)
    dtype = config.float_dtype()
    pay, feats = american._sample_states(gbm, 5, 1 << 12, dtype, None, "joint", None)
    powers = american._monomial_powers(feats.shape[2], 3)
    disc = math.exp(-0.06 / 10)
    fit = american._fit_weights(pay, feats, _put(40.0), powers, disc, 1e-6)
    fit_m = _under(n_dev, lambda: american._fit_weights(pay, feats, _put(40.0), powers, disc, 1e-6))
    # The first solve (the last interior date) sees the same carry.
    w, w_m = fit[0][-1].numpy(), fit_m[0][-1].numpy()
    assert np.abs(w - w_m).max() <= 1e-4 * np.abs(w).max()
    value, stopped = american._apply_policy(pay, feats, _put(40.0), powers, disc, fit)
    value_m, stopped_m = _under(
        n_dev, lambda: american._apply_policy(pay, feats, _put(40.0), powers, disc, fit))
    np.testing.assert_array_equal(value.numpy(), value_m.numpy())
    np.testing.assert_array_equal(stopped.numpy(), stopped_m.numpy())


def test_sobol_indices_under_mesh_match_unsharded():
    a = pt.Distribution("norm", loc=0.0, scale=2.0)
    b = pt.Distribution("norm", loc=0.0, scale=1.0)
    base = pt.sobol_indices(a + b, size=8192, random_state=7)
    sharded = _under(8, lambda: pt.sobol_indices(a + b, size=8192, random_state=7))
    assert sharded.first_order[a] == pytest.approx(base.first_order[a], abs=1e-5)
    assert sharded.total_order[b] == pytest.approx(base.total_order[b], abs=1e-5)


@pytest.mark.parametrize("kw", [
    dict(statistic="mean"),
    dict(statistic="q0.9", method="sobol"),
    dict(statistic="mean", block_size=2**12),
    dict(statistic="cvar0.95", block_size=2**12),
])
def test_sensitivity_under_mesh_matches_unsharded(kw):
    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    y = pt.Distribution("lognorm", s=0.4, scale=1.5)
    sink = 5 * x + y * y
    base = pt.sensitivity(sink, wrt=[x, y], size=2**14, random_state=0, **kw)
    sharded = _under(4, lambda: pt.sensitivity(sink, wrt=[x, y], size=2**14, random_state=0, **kw))
    assert sharded.value == pytest.approx(base.value, rel=1e-5)
    assert len(base.gradients) == 4
    for key, g in base.gradients.items():
        assert sharded.gradients[key] == pytest.approx(g, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("block_size", [None, 2**12])
def test_sweep_under_mesh_is_bitwise(block_size):
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    sink = 2.0 * x + pt.Distribution("expon")
    kw = dict(size=2**14, random_state=0, statistics=("mean", "q0.9", "std"),
              block_size=block_size)
    base = pt.sweep(sink, {(x, "loc"): [-1.0, 0.0, 1.0]}, **kw)
    sharded = _under(4, lambda: pt.sweep(sink, {(x, "loc"): [-1.0, 0.0, 1.0]}, **kw))
    for name in ("mean", "q0.9", "std"):
        np.testing.assert_array_equal(np.asarray(base[name]), np.asarray(sharded[name]))
