"""The port's Longstaff-Schwartz pricer (``engine/american.py``) on the CPU.

The backward induction and the policy pass against the JAX package's on
the same paths: GBM paths, two-asset paths and Heston-like (s, v) states
made with numpy from a seed (2^12 paths, 16 dates; the JAX package is fed
``(n, steps, .)`` arrays, the port their time-major transposes).  In
float64 the weights, means and standard deviations agree within 1e-9 of
each date's largest magnitude and the path values within 1e-9.  In
float32, under one fit (the JAX package's) at most 1e-3 of the paths
exercise on another date and the price over the other paths agrees within
1e-5 relative; each package's own fit agrees on its first solve within
1e-4 of the largest weight, its paths that exercise on the same date
agree within 1e-5 relative, and the prices within 0.1 SE (one path's
flipped decision moves every earlier date's carry, so the fitted policies
can part on paths near the boundary: 6.6% of the Heston-like paths with
one torch thread).  Beside it:
``_monomial_powers`` equal to the JAX tuples, the argument checks' texts
equal to the JAX package's, the seeds (fit, evaluation and replicates on
independent streams, the same seed reproducible), the pricer's laws at
2^12 paths (the put above the European and its intrinsic value, a call
without dividend at its European value, the one-pass estimate at or
above the two-pass, ``method="sobol"``), and the Greeks against float64
central differences of the port's own frozen-policy evaluation on the
same seed, within 1e-4 of max(1, |g|).  The JAX package never simulates a
path here and never prices through its jitted entry points.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import probabilit_tpu as jax_pkg
from probabilit_tpu import config as jax_config
from probabilit_tpu.engine import american as jax_american
import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import american, cuda_exec
from probabilit_tpu_torch.engine.streaming import _derive_seed
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

N = 1 << 12
STEPS = 16
F64_TOL = 1e-9
F32_PRICE_TOL = 1e-5
F32_DATE_SHARE = 1e-3
F32_WEIGHT_TOL = 1e-4
F32_SE_SHARE = 0.1
GREEK_TOL = 1e-4
SE = 4.0


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.fixture
def float64():
    """Both packages in float64 (JAX's is ``jax_enable_x64``)."""
    config.set_dtype(torch.float64)
    jax_config.set_dtype(jnp.float64)
    try:
        yield
    finally:
        config.set_dtype(torch.float32)
        jax_config.set_dtype(jnp.float32)


def put(strike, xp):
    if xp is torch:
        return lambda s: torch.clamp(strike - s, min=0.0)
    return lambda s: jnp.maximum(strike - s, 0.0)


def max_call(strike, xp):
    if xp is torch:
        return lambda a, b: torch.clamp(torch.maximum(a, b) - strike, min=0.0)
    return lambda a, b: jnp.maximum(jnp.maximum(a, b) - strike, 0.0)


def _log_paths(rng, n, s0, mu, sigma, dt):
    z = rng.standard_normal((n, STEPS))
    return s0 * np.exp(np.cumsum((mu - 0.5 * sigma**2) * dt + sigma * math.sqrt(dt) * z, axis=1))


def gbm_case(rng):
    s = _log_paths(rng, N, 36.0, 0.06, 0.2, 1.0 / STEPS)
    return s[..., None], s[..., None], put(40.0, jnp), put(40.0, torch), 0.06, 1.0


def two_asset_case(rng):
    dt = 3.0 / STEPS
    a, b = (_log_paths(rng, N, 100.0, -0.05, 0.2, dt) for _ in range(2))
    pay = np.stack([a, b], axis=2)
    return pay, pay, max_call(100.0, jnp), max_call(100.0, torch), 0.05, 3.0


def heston_like_case(rng):
    """An asset whose volatility follows a positive variance path: the
    regression state is (s, v), the payoff reads s."""
    dt = 0.25 / STEPS
    zv = rng.standard_normal((N, STEPS))
    v = 0.0625 * np.exp(np.cumsum(0.9 * math.sqrt(dt) * zv - 0.5 * 0.81 * dt, axis=1))
    vol = np.sqrt(np.concatenate([np.full((N, 1), 0.0625), v[:, :-1]], axis=1))
    z = 0.1 * zv + math.sqrt(1 - 0.01) * rng.standard_normal((N, STEPS))
    s = 9.0 * np.exp(np.cumsum(0.1 * dt - 0.5 * vol**2 * dt + vol * math.sqrt(dt) * z, axis=1))
    return s[..., None], np.stack([s, v], axis=2), put(10.0, jnp), put(10.0, torch), 0.1, 0.25


CASES = {"gbm": (gbm_case, 3), "two_asset": (two_asset_case, 3),
         "heston_like": (heston_like_case, 3)}


def _both_policies(name, dtype):
    """(JAX fit, JAX value, JAX stopped, port fit, port value, port
    stopped, the payoff paths, the JAX payoff, the discount) on one case's
    paths."""
    make, degree = CASES[name]
    pay, feats, payoff_j, payoff_t, rate, T = make(np.random.default_rng(18))
    pay, feats = pay.astype(dtype), feats.astype(dtype)
    disc = math.exp(-rate * T / STEPS)
    powers = jax_american._monomial_powers(feats.shape[2], degree)
    pj, fj = jnp.asarray(pay), jnp.asarray(feats)
    fit_j = jax_american._fit_weights(pj, fj, payoff_j, powers, disc, 1e-6)
    value_j, stopped_j = jax_american._apply_policy(pj, fj, payoff_j, powers, disc, fit_j)
    pt_, ft = (torch.from_numpy(np.ascontiguousarray(a.transpose(1, 0, 2))) for a in (pay, feats))
    fit_t = american._fit_weights(pt_, ft, payoff_t, powers, disc, 1e-6)
    value_t, stopped_t = american._apply_policy(pt_, ft, payoff_t, powers, disc, fit_t)
    return ([np.asarray(a) for a in fit_j], np.asarray(value_j), np.asarray(stopped_j),
            [a.numpy() for a in fit_t], value_t.numpy(), stopped_t.numpy(), pay, payoff_j, disc)


def exercise_dates(value, stopped, pay, payoff, disc):
    """Each path's exercise date: the date whose discounted payoff is the
    path's value (the last date for a path never stopped early)."""
    cash = np.stack([np.asarray(payoff(*(pay[:, k, j] for j in range(pay.shape[2]))))
                     for k in range(pay.shape[1] - 1)], axis=1).astype(np.float64)
    cash *= disc ** np.arange(1, pay.shape[1])
    early = np.argmin(np.abs(cash - value[:, None].astype(np.float64)), axis=1)
    return np.where(stopped, early, pay.shape[1] - 1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fit_and_policy_match_jax_in_float64(name, float64):
    fit_j, value_j, stopped_j, fit_t, value_t, stopped_t, *_ = _both_policies(name, np.float64)
    for a, b in zip(fit_j, fit_t):  # weights, means, stds: (steps - 1, .)
        assert a.shape == b.shape
        scale = np.abs(a).max(axis=1, keepdims=True)
        assert (np.abs(a - b) <= F64_TOL * scale).all()
    np.testing.assert_array_equal(stopped_j, stopped_t)
    assert np.abs(value_j - value_t).max() <= F64_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_fit_and_policy_match_jax_in_float32(name):
    fit_j, value_j, stopped_j, fit_t, value_t, stopped_t, pay, payoff, disc = _both_policies(
        name, np.float32)
    make, degree = CASES[name]
    _, feats, _, payoff_t, _, _ = make(np.random.default_rng(18))
    powers = american._monomial_powers(feats.shape[2], degree)
    pt_, ft = (torch.from_numpy(np.ascontiguousarray(a.astype(np.float32).transpose(1, 0, 2)))
               for a in (pay, feats))
    # The policy pass under one fit (the JAX package's): the packages round
    # apart only in each date's continuation value.
    value_c, stopped_c = american._apply_policy(
        pt_, ft, payoff_t, powers, disc, [torch.from_numpy(np.array(a)) for a in fit_j])
    dates_j = exercise_dates(value_j, stopped_j, pay, payoff, disc)
    dates_c = exercise_dates(value_c.numpy(), stopped_c.numpy(), pay, payoff, disc)
    same = dates_j == dates_c
    assert np.mean(~same) <= F32_DATE_SHARE
    price_j = value_j[same].astype(np.float64).mean()
    assert abs(value_c.numpy()[same].astype(np.float64).mean() - price_j) <= \
        F32_PRICE_TOL * abs(price_j)
    # Each package's own fit: the first solve (the last interior date, before
    # any exercise decision has changed a carry) rounds apart only in its
    # sums; a later flip of one path's decision moves the next dates'
    # carries, so the fitted policies may part on paths near the boundary.
    # The paths that agree agree in value, and the prices differ by far
    # less than the Monte Carlo error.
    w_j, w_t = fit_j[0][-1], fit_t[0][-1]
    assert np.abs(w_j - w_t).max() <= F32_WEIGHT_TOL * np.abs(w_j).max()
    dates_t = exercise_dates(value_t, stopped_t, pay, payoff, disc)
    same = dates_j == dates_t
    price_j = value_j[same].astype(np.float64).mean()
    assert abs(value_t[same].astype(np.float64).mean() - price_j) <= F32_PRICE_TOL * abs(price_j)
    se = value_j.astype(np.float64).std() / math.sqrt(N)
    gap = abs(value_j.astype(np.float64).mean() - value_t.astype(np.float64).mean())
    assert gap <= F32_SE_SHARE * se


@pytest.mark.parametrize("n_states", [1, 2, 3])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_monomial_powers_match_jax(n_states, degree):
    assert american._monomial_powers(n_states, degree) == jax_american._monomial_powers(
        n_states, degree)


def _errors(call_pt, call_jax, kind=ValueError):
    with pytest.raises(kind) as got:
        call_pt()
    with pytest.raises(kind) as ref:
        call_jax()
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kwargs", [
    dict(method="qmc"), dict(degree=0), dict(size=4), dict(steps=1), dict(state="volatility"),
    dict(replicates=1), dict(replicates=4, two_pass=False),
], ids=["method", "degree", "size", "steps", "state", "replicates", "two_pass"])
def test_price_argument_errors_match_jax(kwargs):
    kwargs = {"size": 64, **kwargs}
    steps = kwargs.pop("steps", 8)

    def call(pkg, xp, fn):
        node = pkg.GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, steps=steps)
        return lambda: fn(node, put(40.0, xp), rate=0.06, **kwargs)

    _errors(call(pt, torch, american.american_price),
            call(jax_pkg, jnp, jax_american.american_price))


@pytest.mark.parametrize("kwargs", [
    dict(wrt=["kappa"]), dict(wrt=[]), dict(replicates=1), dict(degree=0), dict(method="mc"),
], ids=["unknown_slot", "empty", "replicates", "degree", "method"])
def test_greek_argument_errors_match_jax(kwargs):
    def call(pkg, xp, fn):
        node = pkg.GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, steps=8)
        return lambda: fn(node, put(40.0, xp), rate=0.06, size=64, **kwargs)

    _errors(call(pt, torch, american.american_greeks),
            call(jax_pkg, jnp, jax_american.american_greeks))


def test_seeds_are_independent_and_reproducible():
    seed = 7
    fit, evaluate = _derive_seed(seed, 5, 0), _derive_seed(seed, 5, 1)
    reps = [_derive_seed(seed, 5, 2, r) for r in range(3)]
    assert len({fit, evaluate, *reps}) == 5
    g = pt.GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, steps=STEPS)
    draws = [american._sample_states(g, s, N, torch.float32, None, "joint", None)[0][-1, :, 0]
             for s in (fit, evaluate, *reps)]
    z = np.log(torch.stack(draws).double().numpy())
    corr = np.corrcoef(z)
    assert np.abs(corr[np.triu_indices(5, 1)]).max() < SE / math.sqrt(N)
    a = pt.american_price(g, put(40.0, torch), rate=0.06, size=N, random_state=seed)
    b = pt.american_price(g, put(40.0, torch), rate=0.06, size=N, random_state=seed)
    assert a["price"] == b["price"] and np.array_equal(a["weights"], b["weights"])
    # The evaluation streams never touch the fit: replicates keep its weights.
    r = pt.american_price(g, put(40.0, torch), rate=0.06, size=N, random_state=seed,
                          replicates=2)
    assert np.array_equal(r["weights"], a["weights"]) and r["price"] != a["price"]
    c = pt.american_price(g, put(40.0, torch), rate=0.06, size=N, random_state=seed + 1)
    assert not np.array_equal(c["weights"], a["weights"])


def _bs(s0, k, r, sigma, T, call):
    d1 = (math.log(s0 / k) + (r + 0.5 * sigma**2) * T) / (sigma * math.sqrt(T))
    d2 = d1 - sigma * math.sqrt(T)
    if call:
        return s0 * scipy.stats.norm.cdf(d1) - k * math.exp(-r * T) * scipy.stats.norm.cdf(d2)
    return k * math.exp(-r * T) * scipy.stats.norm.cdf(-d2) - s0 * scipy.stats.norm.cdf(-d1)


def test_put_dominates_european_and_intrinsic():
    g = pt.GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, steps=STEPS)
    res = pt.american_price(g, put(40.0, torch), rate=0.06, size=N, random_state=1)
    assert res["price"] > _bs(36.0, 40.0, 0.06, 0.2, 1.0, False) + SE * res["se"]
    assert res["price"] >= 4.0
    assert 0.1 < res["exercise_fraction"] < 1.0
    assert res["weights"].shape == (STEPS - 1, 4)
    assert cuda_exec.LAUNCHES == 0


def test_call_without_dividend_is_european():
    g = pt.GeometricBrownianMotion(s0=100.0, mu=0.06, sigma=0.2, steps=STEPS)
    res = pt.american_price(g, lambda s: torch.clamp(s - 100.0, min=0.0), rate=0.06, size=N,
                            random_state=2)
    assert abs(res["price"] - _bs(100.0, 100.0, 0.06, 0.2, 1.0, True)) <= SE * res["se"]


def test_one_pass_at_or_above_two_pass():
    g = pt.GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, steps=STEPS)
    two = pt.american_price(g, put(40.0, torch), rate=0.06, size=N, random_state=3)
    one = pt.american_price(g, put(40.0, torch), rate=0.06, size=N, random_state=3,
                            two_pass=False)
    assert one["price"] > two["price"] - 3 * math.hypot(two["se"], one["se"])


def test_sobol_joint_and_heston_states():
    node = pt.CorrelatedGBM([100.0, 100.0], [-0.05] * 2, [0.2, 0.2], [[1.0, 0.0], [0.0, 1.0]],
                            T=3.0, steps=9)[0].joint
    res = pt.american_price(node, max_call(100.0, torch), rate=0.05, size=N, degree=3,
                            method="sobol", random_state=0)
    assert res["weights"].shape == (8, 10) and 10.0 < res["price"] < 17.0
    # Heston's chi-square drivers are Newton ppfs on the CPU: 8 dates, one pass.
    h = pt.Heston(s0=9.0, mu=0.1, v0=0.0625, kappa=5.0, theta=0.16, sigma=0.9, rho=0.1, T=0.25,
                  steps=8)

    def price(state):
        return pt.american_price(h, put(10.0, torch), rate=0.1, size=N, random_state=1,
                                 two_pass=False, state=state)

    auto, joint, asset = price("auto"), price("joint"), price("asset")
    custom = price(lambda s, v: (s, torch.sqrt(v)))
    assert auto["price"] == joint["price"] and auto["weights"].shape == (7, 10)
    assert custom["weights"].shape == (7, 10) and asset["weights"].shape == (7, 4)
    assert 0.9 < custom["price"] < 1.3 and 0.9 < asset["price"] < 1.3


def _frozen_value(seed, s0, mu, sigma, rate, degree=3):
    """The port's evaluation pass at the given parameters under the policy
    fitted at (40, 0.06, 0.2, 0.06): ``american_greeks``' function."""
    fit_seed = _derive_seed(seed, 5, 0)
    base = pt.GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, steps=STEPS)
    pay, feats = american._sample_states(base, fit_seed, N, torch.float64, None, "joint", None)
    powers = american._monomial_powers(1, degree)
    fitted = american._fit_weights(pay, feats, put(40.0, torch), powers,
                                   math.exp(-0.06 / STEPS), 1e-6)
    node = pt.GeometricBrownianMotion(s0=s0, mu=mu, sigma=sigma, steps=STEPS)
    pay, feats = american._sample_states(node, _derive_seed(seed, 5, 1), N, torch.float64, None,
                                         "joint", None)
    disc = math.exp(-rate / STEPS)
    return float(american._apply_policy(pay, feats, put(40.0, torch), powers, disc,
                                        fitted)[0].mean())


def test_greeks_match_central_differences_of_the_frozen_policy():
    config.set_dtype(torch.float64)
    try:
        g = pt.GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, steps=STEPS)
        got = pt.american_greeks(g, put(40.0, torch), rate=0.06, size=N, random_state=4)
        base = dict(s0=40.0, mu=0.06, sigma=0.2, rate=0.06)
        assert got["price"] == pytest.approx(_frozen_value(4, **base), rel=1e-12)
        for slot in ("s0", "mu", "sigma", "rate"):
            h = 1e-6 * max(1.0, abs(base[slot]))
            up, down = dict(base), dict(base)
            up[slot] += h
            down[slot] -= h
            fd = (_frozen_value(4, **up) - _frozen_value(4, **down)) / (2 * h)
            assert abs(got[slot] - fd) <= GREEK_TOL * max(1.0, abs(got[slot])), slot
        sub = pt.american_greeks(g, put(40.0, torch), rate=0.06, wrt=["s0"], size=N,
                                 random_state=4)
        assert set(sub) == {"price", "se", "s0"} and sub["s0"] == got["s0"]
    finally:
        config.set_dtype(torch.float32)
    assert -1.0 < got["s0"] < 0.0 and got["sigma"] > 0.0 and got["rate"] < 0.0


def test_greek_replicates_and_non_finite_gradient():
    g = pt.GeometricBrownianMotion(s0=40.0, mu=0.06, sigma=0.2, steps=8)
    reps = pt.american_greeks(g, put(40.0, torch), rate=0.06, wrt=["s0", "sigma"], size=N,
                              random_state=5, replicates=4)
    assert set(reps) == {"price", "se", "replicates", "s0", "s0_sem", "sigma", "sigma_sem"}
    assert reps["s0_sem"] > 0 and -1.0 < reps["s0"] < 0.0
    # The put plus sqrt(s - s): the same values, and a derivative of
    # inf - inf (d sqrt(x)/dx is infinite at 0).
    with pytest.raises(FloatingPointError, match="Non-finite American greeks"):
        pt.american_greeks(g, lambda s: torch.clamp(40.0 - s, min=0.0) + torch.sqrt(s - s),
                           rate=0.06, wrt=["s0"], size=N, random_state=5)
