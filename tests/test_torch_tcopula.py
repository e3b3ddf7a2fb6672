"""The port's Student-t copula correlator (A6b) on the CPU.

Given the same mixing scales (each package's ``_mix_scale`` patched to
return one numpy draw), the port's ``_transform_rows`` and
``_apply_generated`` place the same values in the same rows as the JAX
package's, apart from near-ties (at most 1e-3 of the rows; the two
packages' float32 recolouring products round apart), and
``_copula_uniform_row`` agrees within 1e-6.  ``sorted_uniforms`` gives
ascending rows within 1e-5 of a float64 cumsum of the same exponentials,
with Beta(k, n + 1 - k) marginals.  Through the entry points:
``correlator="tcopula"`` reaches Kendall's tau within 0.02 of (2/pi)
arcsin(rho) in both branches, its upper-tail co-exceedance beats the
Gaussian copula's at the same target, the four-sort branch keeps the
marginals exactly, a streamed estimate equals one shot on the same
blocks (each block's mixing keyed by its own quantiles), one
``sensitivity`` and one ``sweep`` call run, and ``executor="cuda"``
refuses it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

from probabilit_tpu.ops import correlation as jax_correlation
import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, streaming
from probabilit_tpu_torch.engine.streaming import _derive_seed
from probabilit_tpu_torch.ops import correlation, orderstats, ppf, qmc
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

N = 4096
NEAR_TIE_SHARE = 1e-3
UNIFORM_TOL = 1e-6
CUMSUM_TOL = 1e-5
TAU_TOL = 0.02
C3 = np.array([[1.0, 0.6, 0.3], [0.6, 1.0, -0.2], [0.3, -0.2, 1.0]])


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _pair(df=4.0, target=C3):
    """The two packages' t copulas at one target, each drawing its mixing
    scales from one numpy draw."""
    scale = np.sqrt(np.random.default_rng(6).chisquare(df, N) / df).astype(np.float32)
    ref = jax_correlation.StudentTCopula(df=df).set_target(target)
    got = correlation.StudentTCopula(df=df).set_target(target)
    ref._mix_scale = lambda n, dtype, w_key=None: jnp.asarray(scale[:n], dtype)
    got._mix_scale = lambda n, dtype, w_key=None, device=None: torch.from_numpy(scale[:n]).to(dtype)
    return ref, got, scale


def _rows_agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(np.sort(ra), np.sort(rb))  # the same values
        assert np.mean(ra != rb) <= NEAR_TIE_SHARE


def test_transform_rows_match_jax_given_the_mixing():
    ref, got, _ = _pair()
    XT = np.random.default_rng(1).gamma(2.0, size=(3, N)).astype(np.float32)
    a = ref._transform_rows(jnp.asarray(XT), jnp.asarray(ref.P))
    b = got._transform_rows(torch.from_numpy(XT), torch.as_tensor(got.P))
    _rows_agree(a, b.numpy())
    # The mixing moved the ranks: the Gaussian copula's rows differ.
    g = correlation.ImanConover().set_target(C3)._apply_rows(torch.from_numpy(XT))
    assert np.mean(g.numpy() != b.numpy()) > 0.1


def test_apply_generated_matches_jax_given_the_mixing():
    ref, got, _ = _pair()
    rng = np.random.default_rng(2)
    z = rng.standard_normal((3, N)).astype(np.float32)
    x_sorted = np.sort(rng.lognormal(size=(3, N)), axis=1).astype(np.float32)
    a = ref._apply_generated(jnp.asarray(z), jnp.asarray(x_sorted))
    b = got._apply_generated(torch.from_numpy(z), torch.from_numpy(x_sorted))
    _rows_agree(a, b.numpy())


@pytest.mark.parametrize("df", [1.0, 3.0, 4.5])
def test_copula_uniform_row_matches_jax(df):
    ref, got, scale = _pair(df)
    y = np.random.default_rng(3).standard_normal(N).astype(np.float32) * 3.0
    a = np.asarray(ref._copula_uniform_row(jnp.asarray(y), jnp.asarray(scale)))
    b = got._copula_uniform_row(torch.from_numpy(y), torch.from_numpy(scale)).numpy()
    assert np.abs(a - b).max() <= UNIFORM_TOL
    rows = got._copula_uniforms(torch.from_numpy(np.stack([y, -y])), None)
    np.testing.assert_array_equal(rows[0].numpy(), b)


def test_sorted_uniforms_ascend_and_follow_the_order_statistics():
    n, rows = 10_000, 2  # spans three 4096-element blocks
    gen = torch.Generator().manual_seed(9)
    got = orderstats.sorted_uniforms(gen, rows, n)
    assert got.shape == (rows, n) and bool((got[:, 1:] >= got[:, :-1]).all())
    # The same exponentials, summed in float64.
    u = torch.rand((rows, 3, 4096), generator=torch.Generator().manual_seed(9))
    e = -np.log(2.0**-24 + (1 - 2.0**-24) * u.double().numpy()).reshape(rows, -1)[:, : n + 1]
    want = np.cumsum(e, axis=1)
    want = want[:, :n] / want[:, n:]
    assert np.abs(got.double().numpy() - want).max() <= CUMSUM_TOL
    small = orderstats.sorted_uniforms(torch.Generator().manual_seed(10), 4000, 9).numpy()
    for k in (0, 4, 8):
        assert sps.kstest(small[:, k], sps.beta(k + 1, 9 - k).cdf).pvalue > 1e-3, k


def test_checks_and_cache_token_match_jax():
    for df in (0.0, -1.0):
        with pytest.raises(ValueError) as got:
            correlation.StudentTCopula(df=df)
        with pytest.raises(ValueError) as ref:
            jax_correlation.StudentTCopula(df=df)
        assert str(got.value) == str(ref.value)
    for kwargs in ({}, dict(df=3, ties="ordinal", seed=5)):
        assert correlation.StudentTCopula(**kwargs)._cache_token() == \
            jax_correlation.StudentTCopula(**kwargs)._cache_token()
    assert tcompile.resolve_correlator("tcopula") is correlation.StudentTCopula
    assert not correlation.StudentTCopula.gaussian_scores


def _model(rho):
    a, b = pt.Distribution("norm", loc=0.0, scale=1.0), pt.Distribution("expon")
    sink = (a + b).correlate(a, b, corr_mat=np.array([[1.0, rho], [rho, 1.0]]))
    return sink, a, b


def _joint_tail(a, b, q=0.99):
    ta, tb = np.quantile(a, q), np.quantile(b, q)
    return float(np.mean((a > ta) & (b > tb)) / (1 - q))


@pytest.mark.parametrize("branch", ["sample", "sample_from_quantiles"])
def test_tau_tails_and_marginals(branch):
    n, rho = 40_000, 0.6
    q = np.random.default_rng(4).integers(1, 2**23, (n, 2)) / 2**23

    def run(correlator):
        sink, a, b = _model(rho)
        if branch == "sample":
            sink.sample(n, random_state=4, correlator=correlator)
        else:
            sink.sample_from_quantiles(q, correlator=correlator)
        return a.samples_.double().numpy(), b.samples_.double().numpy()

    ta, tb = run(correlation.StudentTCopula(df=2.0))
    tau = sps.kendalltau(ta[:8000], tb[:8000]).statistic
    assert abs(tau - 2 / math.pi * math.asin(rho)) <= TAU_TOL
    ga, gb = run("imanconover")
    assert _joint_tail(ta, tb) > _joint_tail(ga, gb)
    if branch == "sample_from_quantiles":
        for x, col, name in ((ta, 0, "norm"), (tb, 1, "expon")):
            own = ppf.call(name, torch.from_numpy(q[:, col]).float()).double().numpy()
            np.testing.assert_array_equal(np.sort(x), np.sort(own))
    else:
        assert sps.kstest(ta[:5000], "norm").pvalue > 1e-3
        assert sps.kstest(tb[:5000], "expon").pvalue > 1e-3


def test_streamed_estimate_equals_one_shot_on_the_same_blocks():
    sink, _, _ = _model(0.5)
    n, block, seed = 3 * 2048, 2048, 11
    est = pt.estimate(sink, n, block_size=block, random_state=seed, correlator="tcopula")
    streamed = pt.sample_streaming(sink, n, block_size=block, random_state=seed,
                                   correlator="tcopula")
    plan = tcompile.get_plan(sink)
    body = tcompile.build_body(plan, [sink._id], "tcopula", generated=True, drawn=True)
    blocks = [body(qmc.uniform(_derive_seed(seed, 0, b), block, plan.d, torch.float32,
                               "cpu"))[sink._id] for b in range(3)]
    np.testing.assert_array_equal(streamed, torch.cat(blocks).numpy())
    assert est["mean"] == pytest.approx(float(torch.cat(blocks).double().mean()), rel=1e-9)
    # Each block's mixing is keyed by its own leading quantiles: block 1
    # alone is block 1 of the stream, and moving its first quantile moves
    # the mixing of every row.
    q1 = qmc.uniform(_derive_seed(seed, 0, 1), block, plan.d, torch.float32, "cpu")
    np.testing.assert_array_equal(body(q1)[sink._id].numpy(), blocks[1].numpy())
    q1[0, 0] = 0.5
    moved = body(q1)[sink._id].numpy()
    assert np.mean(moved[1:] != blocks[1].numpy()[1:]) > 0.5


def test_sensitivity_and_sweep_take_the_t_copula():
    sink, a, b = _model(0.5)
    got = pt.sensitivity(sink, wrt=a, size=1 << 14, block_size=1 << 12, random_state=0,
                         correlator="tcopula")
    assert got[(a, "loc")] == pytest.approx(1.0, abs=1e-5)  # d E[a + b] / d loc
    res = pt.sweep(sink, {(a, "loc"): [0.0, 1.0, 2.0]}, size=1 << 13, block_size=1 << 11,
                   random_state=0, correlator="tcopula")
    assert np.all(np.diff(res["mean"]) > 0.9)
    assert cuda_exec.LAUNCHES == 0


def test_cuda_executor_refuses_the_t_copula():
    sink, _, _ = _model(0.5)
    with pytest.raises(ValueError, match="supports correlator='imanconover' only"):
        sink.sample(100, random_state=0, correlator="tcopula", executor="cuda", gc_strategy=[])
    with pytest.raises(ValueError, match="supports correlator='imanconover' only"):
        streaming.estimate(sink, 4096, block_size=1024, random_state=0, correlator="tcopula",
                           executor="cuda")
