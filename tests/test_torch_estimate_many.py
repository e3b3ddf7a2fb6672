"""The port's ``estimate_many`` (joint streamed estimates of several nodes),
on the CPU.

The per-block accumulators, the host merge and the finalizer are held
against the JAX package's on the same numpy arrays and carries: quantile
and CVaR sums to 1e-6 relative (both sort and interpolate in float32, the
port sums in float64), histogram counts exactly (the port counts in int64,
the JAX package in two float32 words), merged and finalized statistics to
1e-12 relative (both merge on the host in float64).  Whole runs are held to
the analytic values of the JAX package's ``TestEstimateMany``,
``TestEstimateManyQuantiles``, ``TestEstimateManyParity``,
``TestStreamedCovariance`` and ``TestStreamedMoments``
(``tests/test_streaming_checkpoint.py``), and a Sobol run to float64
statistics of the same draws taken in one shot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from probabilit_tpu.engine import streaming as jax_streaming
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import streaming
from probabilit_tpu_torch.models.distributions import DiscreteDistribution, Distribution
from probabilit_tpu_torch.models.graph import Log, NoOp
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

REL_TOL = 1e-6  # float32 order statistics, float64 sums (see the module docstring)
MERGE_TOL = 1e-12  # float64 host merges and finalizers on the same carries


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


# --- Accumulators, merge and finalize against the JAX package ----------------------------


@pytest.mark.parametrize(
    "block, quantiles, cvar",
    [
        (1 << 18, (0.5, 0.99), (0.95,)),  # rows of 2^17
        (1 << 18, (0.25, 0.9), ()),  # rows, and the rows' partial path
        (1 << 18, (1.0 - 1e-7,), ()),  # endpoint fallback: one sort a node
        (4096, (0.1, 0.5), (0.9, 0.99)),  # small blocks: one sort a node
    ],
)
def test_quantile_accumulators_many_match_reference(block, quantiles, cvar):
    rng = np.random.default_rng(block + len(cvar))
    y = np.stack([rng.lognormal(size=block), rng.normal(size=block), rng.random(block)])
    y = y.astype(np.float32)
    ref_full, ref_partial = jax_streaming._quantile_accumulators_many(quantiles, block, cvar)
    full, partial = streaming._quantile_accumulators_many(quantiles, block, cvar)
    want = np.asarray(ref_full(jnp.asarray(y)), np.float64)
    got = full(torch.from_numpy(y))
    assert got.shape == (3, len(quantiles) + len(cvar)) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=REL_TOL)
    for cnt in (block - 1, block // 2 + 12345 % (block // 2), 1000, 1):
        mask = jnp.arange(block) < cnt
        want = np.asarray(ref_partial(jnp.asarray(y), mask, jnp.int32(cnt)), np.float64)
        got = partial(torch.from_numpy(y), cnt).numpy()
        np.testing.assert_allclose(got, want, rtol=REL_TOL, err_msg=f"cnt={cnt}")
    # One node's accumulators are the many accumulators' first row.
    one_full, _ = streaming._quantile_accumulators(quantiles, block, cvar)
    torch.testing.assert_close(one_full(torch.from_numpy(y[0])), full(torch.from_numpy(y))[0],
                               rtol=0, atol=0)


def test_histogram_accumulators_many_match_reference():
    rng = np.random.default_rng(5)
    y = rng.normal(scale=2.0, size=(3, 20_000)).astype(np.float32)
    y[0, :7] = [np.nan, np.inf, -np.inf, -3.0, 3.0, 2.99999, -2.99999]
    mask = rng.random(20_000) < 0.3
    histogram = (-3.0, 3.0, 37)
    ref = jax_streaming._histogram_accumulators_many(histogram)
    counts = streaming._histogram_accumulators_many(histogram)
    for m in (None, mask):
        want = np.asarray(ref(jnp.asarray(y), None if m is None else jnp.asarray(m)))
        got = counts(torch.from_numpy(y), None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.int64 and got.shape == (3, 39)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert streaming._histogram_accumulators_many(None)(torch.from_numpy(y)).shape == (3, 0)


def _many_carries(rng, m, levels, hist_len, count=3):
    """Host carries of ``count`` segments of M nodes (the port's layout)."""
    carries = []
    for k in range(count):
        total = 1000.0 * (k + 1) if k != 1 else 0.0  # a zero-accept segment (where=)
        a = rng.normal(size=(m, m))
        carries.append((
            total, rng.normal(size=m), rng.random(m) * total, -rng.random(m) * 5, rng.random(m) * 5,
            True, rng.normal(size=(m, levels)) * total, rng.normal(), rng.random() * total,
            rng.normal(size=m) * total, rng.integers(0, 2**30, size=(m, hist_len)),
            rng.normal(size=m) * total, rng.random(m) * 10 * total, a @ a.T * total,
        ))
    return carries


def _jax_layout(carry):
    """A port carry in the JAX package's layout: histogram counts as two
    float32 words (hi * 2^23 + lo)."""
    counts = np.asarray(carry[10])
    pair = np.stack([counts // 2**23, counts % 2**23]).astype(np.float32)
    return (*carry[:10], pair, *carry[11:])


@pytest.mark.parametrize("control_mu", [None, 0.3])
def test_merge_many_carries_matches_reference(control_mu):
    rng = np.random.default_rng(7)
    carries = _many_carries(rng, 3, 2, 6)
    want, want_means = jax_streaming._merge_many_carries(
        [_jax_layout(c) for c in carries], control_mu
    )
    got, got_means = streaming._merge_many_carries(carries, control_mu)
    assert len(got_means) == len(want_means) == 2  # the zero-accept segment stays out
    for g, w in zip(got_means, want_means):
        np.testing.assert_allclose(g, w, rtol=MERGE_TOL)
    for i in (0, 1, 2, 3, 4, 6, 7, 8, 9, 11, 12, 13):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i], np.float64),
                                   rtol=MERGE_TOL, atol=1e-9, err_msg=f"field {i}")
    assert bool(got[5]) is bool(want[5]) is True
    pair = np.asarray(want[10])
    np.testing.assert_array_equal(got[10].numpy(), np.rint(pair[0] * 2.0**23 + pair[1]))


@pytest.mark.parametrize("mode", ["plain", "where", "control"])
def test_finalize_many_matches_reference(mode):
    rng = np.random.default_rng(8)
    quantiles, cvar, histogram = (0.5, 0.9), (0.99,), (-1.0, 1.0, 8)
    carry = list(_many_carries(rng, 3, 3, 10, count=1)[0])
    x = Distribution("norm")
    nodes = [x, x + 1.0, x * 2.0]
    kwargs = dict(quantiles=quantiles, cvar=cvar, histogram=histogram, moments=True,
                  covariance=True, where=(x > 0) if mode == "where" else None,
                  control_mu=0.2 if mode == "control" else None)
    if mode == "where":
        kwargs.update(quantiles=(), cvar=())
    want = jax_streaming._finalize_many(nodes, _jax_layout(carry), 200_000, **kwargs)
    got = streaming._finalize_many(nodes, tuple(carry), 200_000, **kwargs)
    for node in nodes:
        assert got[node].keys() == want[node].keys()
        for key, value in want[node].items():
            if key == "histogram":
                for k in value:
                    np.testing.assert_array_equal(got[node][key][k], value[k])
            elif key in ("cov", "corr"):
                np.testing.assert_allclose(got[node][key], value, rtol=MERGE_TOL)
            else:
                assert got[node][key] == pytest.approx(value, rel=MERGE_TOL), key
    carry[5] = False
    with pytest.raises(ValueError, match="non-finite"):
        streaming._finalize_many(nodes, tuple(carry), 200_000)


# --- TestEstimateMany ------------------------------------------------------------------


def test_joint_consistency_and_moments():
    eq = Distribution("lognorm", s=0.25)
    bo = Distribution("norm", loc=1.02, scale=0.05)
    total = 0.6 * eq + 0.4 * bo
    res = streaming.estimate_many([eq, bo, total], 100_000, block_size=16384, random_state=0)
    assert np.isclose(res[eq]["mean"], np.exp(0.25**2 / 2), atol=3e-3)
    assert np.isclose(res[bo]["mean"], 1.02, atol=1e-3)
    assert np.isclose(res[bo]["std"], 0.05, atol=2e-3)
    # The same joint draws: the linear identity holds to float rounding.
    lin = 0.6 * res[eq]["mean"] + 0.4 * res[bo]["mean"]
    assert abs(res[total]["mean"] - lin) < 1e-5
    for stats in res.values():
        assert stats["sem"] == pytest.approx(stats["std"] / np.sqrt(stats["n"]), rel=1e-9)


def test_program_cached_across_calls_and_sizes():
    a = Distribution("norm")
    b = a * 2
    streaming.estimate_many([a, b], 1000, block_size=256, random_state=0)
    builds = streaming._MANY_BUILDS
    res = streaming.estimate_many([a, b], 3000, block_size=256, random_state=1)
    assert streaming._MANY_BUILDS == builds
    assert res[a]["n"] == 3000
    # A later correlate() moves the graph epoch: a new program, not a stale one.
    c = Distribution("norm")
    s = (b + c).correlate(a, c, corr_mat=np.array([[1.0, 0.8], [0.8, 1.0]]))
    res = streaming.estimate_many([a, b], 3000, block_size=256, random_state=1)
    assert streaming._MANY_BUILDS == builds + 1
    corr = streaming.estimate_many([a, c, s], 1 << 14, block_size=1 << 12, random_state=2,
                                   covariance=True)
    assert corr[a]["corr"][1] == pytest.approx(0.8, abs=0.02)


def test_correlated_model():
    a, b = Distribution("norm"), Distribution("norm")
    s = a + b
    s.correlate(a, b, corr_mat=np.array([[1, 0.6], [0.6, 1.0]]))
    res = streaming.estimate_many([a, b, s], 200_000, block_size=32768, random_state=2,
                                  executor=None)
    assert np.isclose(res[s]["var"], 3.2, atol=0.05)
    assert np.isclose(res[a]["std"], 1.0, atol=0.02)


def test_qmc_method():
    a = Distribution("uniform")
    b = Distribution("norm", loc=3)
    res = streaming.estimate_many([a, b], 32768, block_size=8192, random_state=0, method="sobol")
    assert np.isclose(res[a]["mean"], 0.5, atol=1e-3)
    assert np.isclose(res[b]["mean"], 3.0, atol=1e-2)


def test_validation():
    a = Distribution("norm")
    with pytest.raises(ValueError, match="at least one"):
        streaming.estimate_many([], 100)
    with pytest.raises(ValueError, match="appears twice"):
        streaming.estimate_many([a, a], 100)
    with pytest.raises(ValueError, match="graph nodes"):
        streaming.estimate_many([3.0], 100)
    sd = DiscreteDistribution(["a", "b"])
    with pytest.raises(ValueError, match="non-numeric"):
        streaming.estimate_many([sd], 100, block_size=64)
    with pytest.raises(ValueError, match="size must be"):
        streaming.estimate_many([a], 0)


def test_nonfinite_guard():
    bad = Log(Distribution("norm", loc=-100.0))
    with pytest.raises(ValueError, match="non-finite"):
        streaming.estimate_many([bad], 10_000, block_size=4096, random_state=0)
    # Off the condition a node may be NaN: those lanes are never inspected.
    x = Distribution("norm")
    log_x = Log(x)
    res = streaming.estimate_many([x, log_x], 8192, block_size=2048, random_state=0,
                                  where=x > 0.0)
    assert np.isfinite(res[log_x]["mean"]) and res[log_x]["max"] < 5.0


def test_executor_cuda_refuses_the_noop_sink():
    """The kernels refuse a NoOp sink, as the TPU kernel does; "auto" runs
    the plain executor, as it does on the card."""
    a = Distribution("norm")
    with pytest.raises(ValueError, match="not eligible for executor='cuda'"):
        streaming.estimate_many([a, a * 2.0], 1000, block_size=256, executor="cuda")
    auto = streaming.estimate_many([a, a * 2.0], 1000, block_size=256, random_state=3)
    plain = streaming.estimate_many([a, a * 2.0], 1000, block_size=256, random_state=3,
                                    executor=None)
    assert auto[a]["mean"] == plain[a]["mean"]


def test_node_order_changes_no_statistic():
    """The NoOp plan's layout fixes the draws: the same nodes in another
    order give each node the same statistics for a seed."""
    a = Distribution("norm")
    b = Distribution("expon")
    c = a * b
    kwargs = dict(block_size=1 << 12, random_state=4, quantiles=(0.5,), cvar=(0.9,),
                  histogram=(-3.0, 3.0, 12), moments=True, covariance=True)
    one = streaming.estimate_many([a, b, c], 10_000, **kwargs)
    two = streaming.estimate_many([c, a, b], 10_000, **kwargs)
    for node in (a, b, c):
        for key in ("n", "mean", "var", "min", "max", "q0.5", "cvar0.9", "skew", "kurt"):
            assert two[node][key] == pytest.approx(one[node][key], rel=1e-12), key
        np.testing.assert_array_equal(two[node]["histogram"]["counts"],
                                      one[node]["histogram"]["counts"])
    perm = [1, 2, 0]  # rows of [c, a, b] in [a, b, c] order
    cov_one = np.stack([one[n]["cov"] for n in (a, b, c)])
    cov_two = np.stack([two[n]["cov"] for n in (c, a, b)])[np.ix_(perm, perm)]
    np.testing.assert_allclose(cov_two, cov_one, rtol=1e-12)


# --- TestEstimateManyQuantiles ---------------------------------------------------------


def test_per_node_quantiles_match_analytic():
    eq = Distribution("lognorm", s=0.25)
    bo = Distribution("norm", loc=1.02, scale=0.05)
    total = 0.6 * eq + 0.4 * bo
    res = streaming.estimate_many(
        [eq, bo, total], 200_000, block_size=32768, random_state=0, quantiles=(0.5, 0.95)
    )
    assert res[bo]["q0.5"] == pytest.approx(1.02, abs=2e-3)
    assert res[bo]["q0.95"] == pytest.approx(scipy.stats.norm.ppf(0.95, 1.02, 0.05), abs=2e-3)
    assert res[eq]["q0.95"] == pytest.approx(scipy.stats.lognorm.ppf(0.95, 0.25), abs=5e-3)
    assert res[total]["q0.95"] > res[total]["q0.5"]


def test_no_quantiles_by_default_and_cache_split():
    a = Distribution("uniform")
    plain = streaming.estimate_many([a], 4096, block_size=1024, random_state=1)
    assert "q0.5" not in plain[a]
    withq = streaming.estimate_many([a], 4096, block_size=1024, random_state=1, quantiles=(0.25,))
    assert withq[a]["q0.25"] == pytest.approx(0.25, abs=0.02)
    with pytest.raises(ValueError, match="in \\(0, 1\\)"):
        streaming.estimate_many([a], 100, block_size=64, quantiles=(1.5,))


def test_rows_path_quantiles_and_partial_block():
    """Blocks of 2^18 take the rows of 2^17 (one sort for both nodes), the
    final partial block its boundary row."""
    x = Distribution("norm")
    y = Distribution("expon")
    res = streaming.estimate_many([x, y], (1 << 18) + 70_000, block_size=1 << 18,
                                  random_state=5, quantiles=(0.1, 0.9))
    assert res[x]["q0.9"] == pytest.approx(scipy.stats.norm.ppf(0.9), abs=0.01)
    assert res[y]["q0.1"] == pytest.approx(scipy.stats.expon.ppf(0.1), abs=0.005)


# --- TestEstimateManyParity ------------------------------------------------------------


def test_cvar_rides_quantile_sorts():
    x = Distribution("norm", loc=1.0, scale=2.0)
    y = Distribution("expon")
    res = streaming.estimate_many(
        [x, y], 200_000, block_size=32_768, random_state=0, quantiles=(0.95,), cvar=(0.95,)
    )
    want_x = 1.0 + 2.0 * scipy.stats.norm.pdf(scipy.stats.norm.ppf(0.95)) / 0.05
    assert res[x]["cvar0.95"] == pytest.approx(want_x, rel=0.01)
    assert res[y]["cvar0.95"] == pytest.approx(1.0 - np.log(0.05), rel=0.01)
    for node in (x, y):
        assert res[node]["cvar0.95"] > res[node]["q0.95"]


def test_per_node_histograms_exact():
    x = Distribution("uniform")
    y = x * 2.0
    res = streaming.estimate_many(
        [x, y], 50_000, block_size=8_192, random_state=1, histogram=(0.0, 2.0, 8)
    )
    for node in (x, y):
        h = res[node]["histogram"]
        assert int(h["counts"].sum()) + h["underflow"] + h["overflow"] == 50_000
    assert res[x]["histogram"]["counts"][4:].sum() == 0
    assert res[x]["histogram"]["overflow"] == 0
    assert res[y]["histogram"]["counts"].min() > 0.8 * 50_000 / 8


def test_where_matches_single_sink():
    x = Distribution("norm", loc=1.0, scale=2.0)
    y = x * x
    cond = x > 2.0
    many = streaming.estimate_many([x, y], 100_000, block_size=16_384, random_state=2, where=cond)
    one = streaming.estimate(x, 100_000, block_size=16_384, random_state=2, where=cond)
    # y and the condition add no column: the same draws as estimate(where=).
    assert many[x]["n"] == one["n"]
    assert many[x]["mean"] == pytest.approx(one["mean"], rel=1e-12)
    assert many[x]["acceptance"] == pytest.approx(one["acceptance"])
    assert many[x]["n_total"] == 100_000
    # Conditional consistency across nodes: y = x^2 given x > 2.
    assert many[y]["min"] >= many[x]["min"] ** 2 - 1e-3


def test_shared_control_adjusts_every_node():
    a = Distribution("norm", loc=1.0, scale=1.0)
    b = Distribution("expon")
    tot = a + b
    res = streaming.estimate_many([tot, b], 65_536, block_size=16_384, random_state=3,
                                  control=(a, 1.0))
    assert res[tot]["control_beta"] == pytest.approx(1.0, abs=0.05)
    assert abs(res[b]["control_beta"]) < 0.05
    assert res[tot]["mean"] == pytest.approx(2.0, abs=0.02)
    plain = streaming.estimate_many([tot], 65_536, block_size=16_384, random_state=3)
    assert res[tot]["sem"] < 0.75 * plain[tot]["sem"]


def test_rqmc_replicates_give_valid_joint_error_bars():
    eq = Distribution("lognorm", s=0.25)
    bo = Distribution("norm", loc=1.02, scale=0.05)
    total = 0.6 * eq + 0.4 * bo
    res = streaming.estimate_many(
        [eq, bo, total], 65_536, block_size=8_192, random_state=4, method="sobol",
        replicates=4, quantiles=(0.95,), cvar=(0.95,),
    )
    for node in (eq, bo, total):
        assert res[node]["replicates"] == 4
        assert res[node]["cvar0.95"] > res[node]["q0.95"]
    lin = 0.6 * res[eq]["mean"] + 0.4 * res[bo]["mean"]
    assert abs(res[total]["mean"] - lin) < 1e-4
    iid = streaming.estimate_many([total], 65_536, block_size=8_192, random_state=4)
    assert res[total]["sem"] < iid[total]["sem"]


def test_replicates_with_control_and_their_seeds(monkeypatch):
    a = Distribution("norm", loc=1.0)
    tot = a + Distribution("expon")
    seeds = []
    real = streaming._many_carry
    monkeypatch.setattr(streaming, "_many_carry",
                        lambda nodes, size, block, seed, *a, **k: seeds.append(seed)
                        or real(nodes, size, block, seed, *a, **k))
    res = streaming.estimate_many([tot], 65_536, block_size=8_192, random_state=5,
                                  control=(a, 1.0), replicates=4)
    assert res[tot]["mean"] == pytest.approx(2.0, abs=0.02)
    assert res[tot]["replicates"] == 4
    assert seeds == [streaming._derive_seed(5, 1, r) for r in range(4)]


def test_composition_rules_match_estimate():
    x = Distribution("norm")
    cond = x > 0
    with pytest.raises(ValueError, match="quantiles=/cvar="):
        streaming.estimate_many([x], 1000, block_size=256, where=cond, quantiles=(0.5,))
    with pytest.raises(ValueError, match="quantiles=/cvar="):
        streaming.estimate_many([x], 1000, block_size=256, where=cond, cvar=(0.95,))
    with pytest.raises(ValueError, match="control="):
        streaming.estimate_many([x], 1000, block_size=256, where=cond, control=(x, 0.0))
    with pytest.raises(ValueError, match="histogram must be"):
        streaming.estimate_many([x], 1000, block_size=256, histogram=3)
    with pytest.raises(ValueError, match="replicates must be"):
        streaming.estimate_many([x], 1000, block_size=256, replicates=1)
    with pytest.raises(ValueError, match="divisible"):
        streaming.estimate_many([x], 1001, block_size=256, replicates=4)
    with pytest.raises(ValueError, match="\\(node, known_mean\\)"):
        streaming.estimate_many([x], 1000, block_size=256, control=x)


# --- TestStreamedMoments (the many part) and TestStreamedCovariance ---------------------


def test_moments_parity():
    a = Distribution("lognorm", s=0.5)
    b = Distribution("norm")
    out = streaming.estimate_many([a, b], 1 << 15, block_size=1 << 12, random_state=6,
                                  moments=True)
    g1 = float(scipy.stats.lognorm.stats(0.5, moments="s"))
    assert out[a]["skew"] == pytest.approx(g1, abs=0.3)
    assert abs(out[b]["skew"]) < 0.06 and abs(out[b]["kurt"]) < 0.15
    out0 = streaming.estimate_many([a, b], 4096, block_size=1024, random_state=6)
    assert "skew" not in out0[a]


def test_covariance_matches_analytic_linear_model():
    x = Distribution("norm")
    y = 2.0 * x + Distribution("norm")
    z = -1.0 * x + Distribution("norm", scale=0.5)
    out = streaming.estimate_many([x, y, z], 1 << 16, block_size=1 << 13, random_state=0,
                                  covariance=True)
    corr = np.stack([out[n]["corr"] for n in (x, y, z)])
    cov = np.stack([out[n]["cov"] for n in (x, y, z)])
    assert np.allclose(corr, corr.T, atol=1e-6)
    assert np.allclose(np.diag(corr), 1.0)
    for i, n in enumerate((x, y, z)):
        assert cov[i, i] == pytest.approx(out[n]["var"], rel=1e-4)
    assert corr[0, 1] == pytest.approx(2 / np.sqrt(5.0), abs=0.01)
    assert corr[0, 2] == pytest.approx(-1 / np.sqrt(1.25), abs=0.01)
    assert corr[1, 2] == pytest.approx(-2 / np.sqrt(6.25), abs=0.01)


def test_covariance_default_off():
    x = Distribution("norm")
    out = streaming.estimate_many([x, x + 1.0], 4096, block_size=1024, random_state=1)
    assert "cov" not in out[x] and "corr" not in out[x]


def test_covariance_composes_with_where():
    x = Distribution("norm")
    y = 2.0 * x + Distribution("norm")
    out = streaming.estimate_many([x, y], 1 << 16, block_size=1 << 13, random_state=2,
                                  covariance=True, where=x > 0)
    v = 1.0 - 2.0 / np.pi
    assert float(out[x]["corr"][1]) == pytest.approx(2 * v / np.sqrt(v * (4 * v + 1)), abs=0.02)
    assert out[x]["acceptance"] == pytest.approx(0.5, abs=0.02)


def test_covariance_composes_with_replicates_and_sequential():
    x = Distribution("norm")
    y = 2.0 * x + Distribution("norm")
    rep = streaming.estimate_many([x, y], 1 << 14, block_size=1 << 12, random_state=3,
                                  covariance=True, replicates=4)
    assert float(rep[x]["corr"][1]) == pytest.approx(2 / np.sqrt(5.0), abs=0.03)
    seq = streaming.estimate_many([x, y], 1 << 12, block_size=1 << 12, random_state=4,
                                  covariance=True, moments=True, target_sem=0.05)
    assert seq[x]["converged"]
    assert float(seq[x]["corr"][1]) == pytest.approx(2 / np.sqrt(5.0), abs=0.05)


def test_covariance_matrix_reassembly_order():
    a = Distribution("norm")
    b = Distribution("expon")
    c = a * b
    nodes = [a, b, c]
    out = streaming.estimate_many(nodes, 1 << 14, block_size=1 << 12, random_state=5,
                                  covariance=True)
    cov = np.stack([out[n]["cov"] for n in nodes])
    eig = np.linalg.eigvalsh((cov + cov.T) / 2)
    assert eig.min() > -1e-6 * max(eig.max(), 1.0)


# --- Exactness against one shot (phase 19's check, at a CPU size) ----------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sobol_estimate_equals_one_shot_statistics(dtype):
    """Streamed Sobol blocks are the one-shot sequence's rows: the count and
    extremes are equal, the moments and co-moments within 1e-9 relative of
    float64 statistics of the one-shot draws, the histograms equal to the
    bin rule applied to them."""
    previous = config.float_dtype()
    config.set_dtype(dtype)
    try:
        a = Distribution("lognorm", s=0.5)
        b = Distribution("norm", loc=1.0, scale=2.0)
        c = a * b + Distribution("uniform")
        nodes = [a, b, c]
        n, histogram = 1 << 14, (-4.0, 8.0, 24)
        out = streaming.estimate_many(nodes, n, block_size=1 << 12, random_state=7,
                                      method="sobol", histogram=histogram, covariance=True)
        NoOp(*nodes).sample(n, random_state=7, method="sobol", gc_strategy=nodes)
        draws = np.stack([node.samples_.to(torch.float32).double().numpy() for node in nodes])
    finally:
        config.set_dtype(previous)
    cov = np.cov(draws, bias=True)
    counts = streaming._histogram_accumulators_many(histogram)(
        torch.from_numpy(draws.astype(np.float32))).numpy()
    for i, node in enumerate(nodes):
        st = out[node]
        assert st["n"] == n
        assert st["min"] == draws[i].min() and st["max"] == draws[i].max()
        assert st["mean"] == pytest.approx(draws[i].mean(), rel=1e-9)
        assert st["var"] == pytest.approx(draws[i].var(), rel=1e-9)
        np.testing.assert_allclose(st["cov"], cov[i], rtol=1e-9)
        h = st["histogram"]
        np.testing.assert_array_equal(
            np.concatenate([[h["underflow"]], h["counts"], [h["overflow"]]]), counts[i])
