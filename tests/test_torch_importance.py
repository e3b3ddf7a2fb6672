"""The port's quantile-space importance tilting (``engine/importance.py``)
on the CPU, against the JAX package.

``suggest_tilt`` is host arithmetic: equal to the JAX package's within
1e-12 relative over a grid of p.  ``tilted``'s nodes are held elementwise
on one explicit quantile matrix (rows with the first uniform near 0
included, down to the 2^-24 clamp, so the stacked depth reaches its 33.3
e-folds) in both tails.  The packages' float32 ``log`` may round one ulp
apart, and the tilt's depth (``log(J + V2) - 24 ln 2`` lower, ``log(V)``
upper) carries that ulp into u.  So ``x`` is held within 4 float32 ulps of
max(1, |x|) (the normal ppf's band), plus the ppf's slope times the shift
in u that two float32 ulps of the depth and two of u make, where u
lies in [0.01, 0.99], and within 1e-4 of its largest magnitude elsewhere
(the ppf's tails); ``w`` within 8e-6 relative everywhere (``w`` is the exp
of the depth times (1 - k) / k, and one float32 ulp of a depth up to 33.3
is 4e-6 of it).  Then the warnings and refusals with the JAX package's texts, no
kernel on the path, and at CPU sizes ``E[w] = 1`` and P(Z < -6) within 4
SE of ``scipy.stats.norm.cdf(-6)``.
"""

import warnings

import numpy as np
import pytest
import scipy.stats
import torch

from probabilit_tpu.engine import importance as jax_importance
import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.engine import importance
from probabilit_tpu_torch.ops.qmc import clamp_open_unit
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

ULPS = 4
TAIL_TOL = 1e-4
W_REL = 8e-6
SCALE = 2.0  # the tilted normal's scale
P_GRID = [0.4, 0.1, 1e-2, 1e-3, 1e-5, 1e-7, 1e-9, 1e-12, 1e-15]


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.mark.parametrize("p", P_GRID)
def test_suggest_tilt_matches_jax(p):
    want = jax_importance.suggest_tilt(p)
    assert importance.suggest_tilt(p) == pytest.approx(want, rel=1e-12)


def test_small_p_optimum_is_the_asymptote():
    """k* -> c*/p with c* = 1.5936 the root of (c - 2) e^c + 2 = 0."""
    assert importance.suggest_tilt(1e-12) * 1e-12 == pytest.approx(1.5936, rel=1e-3)


def test_wide_families_match_jax():
    assert importance.wide_families() == jax_importance.wide_families()
    assert pt.wide_families() == importance.wide_families() and "norm" in pt.wide_families()


def _matrix(d, seed):
    """Float32-exact uniforms, the first column's first rows down to 2^-24."""
    q = np.random.default_rng(seed).integers(1, 2**23, (4096, d)) / 2**23
    q[:64, 0] = np.geomspace(2.0**-24, 1e-3, 64)
    if d == 2:
        q[:32, 1] = np.geomspace(2.0**-24, 0.5, 32)
    return q


def _tilted_quantile(q, k, tail):
    """(u, du) of each row in float64 from the clamped uniforms: the tilted
    quantile, and the shift in it that two float32 ulps of the depth's
    logarithm and two of u itself (the last ``exp``/``expm1``) make."""
    v = clamp_open_unit(torch.as_tensor(q, dtype=torch.float32)).double().numpy()
    if tail == "lower":
        log_j = np.log(np.floor(v[:, 0] * (2.0**24 - 1.0)) + v[:, 1])
        u = -np.expm1((log_j - 24.0 * np.log(2.0)) / k)
        du = (1.0 - u) * 2.0 * np.spacing(np.abs(log_j).astype(np.float32)) / k
    else:
        log_v = np.log(v[:, 0])
        u = np.exp(log_v / k)
        du = u * 2.0 * np.spacing(np.abs(log_v).astype(np.float32)) / k
    return u, du + 2.0 * np.spacing(u.astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("tail,k", [("lower", 3.0), ("lower", 1e3), ("lower", 1.6e9),
                                    ("upper", 3.0), ("upper", 50.0)])
def test_tilted_draws_and_weights_match_jax(tail, k):
    x, w = jax_importance.tilted("norm", k=k, tail=tail, loc=0.5, scale=SCALE)
    sink = x * w
    q = _matrix(2 if tail == "lower" else 1, seed=int(k) % 97)
    sink.sample_from_quantiles(q)
    jx, jw = np.asarray(x.samples_, np.float64), np.asarray(w.samples_, np.float64)
    mapping = interop.from_reference(sink)
    mapping[sink._id].sample_from_quantiles(q)
    px = mapping[x._id].samples_.numpy().astype(np.float64)
    pw = mapping[w._id].samples_.numpy().astype(np.float64)
    assert np.all(np.isfinite(jx)) and np.all(np.isfinite(jw))
    u, du = _tilted_quantile(q, k, tail)
    band = (u >= 0.01) & (u <= 0.99)
    ulp = np.spacing(np.float32(1.0)).astype(np.float64)
    slope = SCALE / scipy.stats.norm.pdf(scipy.stats.norm.ppf(np.clip(u, 1e-300, 1.0)))
    tol = ULPS * ulp * np.maximum(1.0, np.abs(jx)) + slope * du
    assert np.all(np.abs(px - jx)[band] <= tol[band])
    assert np.all(np.abs(px - jx)[~band] <= TAIL_TOL * np.abs(jx).max())
    np.testing.assert_allclose(pw, jw, rtol=W_REL, atol=0)


def test_lower_tilt_reaches_its_stacked_depth():
    """The smallest clamped uniforms give a depth of 33.3 e-folds: the
    weight exp(a (k - 1) / k) / k there."""
    k = 64.0
    _, w = importance.tilted("norm", k=k)
    w.sample_from_quantiles([[2.0**-24, 2.0**-24], [0.5, 0.5]])
    a = np.log(w.samples_.double().numpy() * k) * k / (k - 1.0)
    assert a[0] == pytest.approx(48 * np.log(2.0), rel=1e-5)  # 2^-48 deep
    assert a[1] == pytest.approx(-np.log(np.floor(0.5 * (2**24 - 1)) / 2**24 + 0.5 / 2**24),
                                 rel=1e-5)


def test_warnings_match_jax():
    cases = [
        dict(distr="norm", k=2.0**25, tail="upper"),
        dict(distr="t", k=2.0**25, tail="lower", df=5),
    ]
    for case in cases:
        texts = []
        for mod in (jax_importance, importance):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                mod.tilted(**case)
            texts.append([str(c.message) for c in caught])
        assert texts[1] == texts[0] and len(texts[0]) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        importance.tilted("norm", k=2.0**30, tail="lower")
        importance.tilted("lognorm", k=2.0**30, tail="lower", s=0.5)
        importance.tilted("t", k=100.0, tail="lower", df=5)


def test_upper_tilt_warning_is_silent_in_float64():
    config.set_dtype(torch.float64)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            importance.tilted("norm", k=2.0**25, tail="upper")
    finally:
        config.set_dtype(torch.float32)


@pytest.mark.parametrize("k,tail", [(0.0, "lower"), (-1.0, "lower"), (float("inf"), "lower"),
                                    (float("nan"), "upper"), (2.0, "mid")])
def test_refusals_match_jax(k, tail):
    messages = []
    for mod in (jax_importance, importance):
        with pytest.raises(ValueError) as info:
            mod.tilted("norm", k=k, tail=tail)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


@pytest.mark.parametrize("p", [0.0, 1.0, -0.5, 2.0])
def test_suggest_tilt_refusals_match_jax(p):
    messages = []
    for mod in (jax_importance, importance):
        with pytest.raises(ValueError) as info:
            mod.suggest_tilt(p)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


def test_six_sigma_tail_and_unit_weight_mean():
    """P(Z < -6) at the suggested tilt within 4 SE of the exact value, on
    the plain executor (no kernel takes a QuantileTransform); E[w] = 1 at
    a gentle tilt (E[w^2] is finite only for k < 2)."""
    before = cuda_exec.LAUNCHES
    z, w = pt.tilted("norm", k=pt.suggest_tilt(1e-9), tail="lower")
    est = pt.estimate((z < -6.0) * w, 1 << 16, block_size=1 << 14, random_state=0)
    exact = scipy.stats.norm.cdf(-6.0)
    assert abs(est["mean"] - exact) <= 4 * est["sem"]
    assert est["sem"] < 0.01 * exact
    _, w_gentle = pt.tilted("norm", k=1.5, tail="lower")
    ew = pt.estimate(w_gentle, 1 << 16, block_size=1 << 14, random_state=1)
    assert abs(ew["mean"] - 1.0) <= 4 * ew["sem"]
    assert cuda_exec.LAUNCHES == before
