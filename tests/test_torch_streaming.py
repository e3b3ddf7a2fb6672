"""Streamed ``estimate`` and ``sample_streaming`` of the port, on the CPU.

The per-block accumulators and ``_finalize_estimate`` are held against
the JAX package's on the same numpy inputs (quantile and CVaR sums to
1e-6 relative: both sort in float32 and interpolate in float32, the port
sums in float64; histogram counts exactly).  ``estimate`` is held against
numpy float64 on the very blocks it folds (``sample_streaming`` with the
same seed), against the JAX ``estimate`` on ``mixed_dag_20`` within 5
standard errors (the two draw different random streams), and against the
analytic values the JAX package's own streaming tests use.  The kernels'
``start`` argument is held here through the plain twins; on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from probabilit_tpu.engine import streaming as jax_streaming
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, streaming
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.models.graph import Exp, Log
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

REL_TOL = 1e-6


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


# --- Accumulators against the JAX package -----------------------------


@pytest.mark.parametrize(
    "block, quantiles, cvar",
    [
        (1 << 18, (0.5, 0.99), (0.95,)),  # rows of 2^17
        (1 << 18, (0.25, 0.9), ()),  # rows, and the rows' partial path
        (1 << 18, (1.0 - 1e-7,), ()),  # endpoint fallback: one full sort
        (4096, (0.1, 0.5), (0.9, 0.99)),  # small blocks: one full sort
    ],
)
def test_quantile_accumulators_match_reference(block, quantiles, cvar):
    rng = np.random.default_rng(block + len(cvar))
    x = rng.lognormal(size=block).astype(np.float32)
    ref_full, ref_partial = jax_streaming._quantile_accumulators(quantiles, block, cvar)
    full, partial = streaming._quantile_accumulators(quantiles, block, cvar)
    want = np.asarray(ref_full(jnp.asarray(x)), np.float64)
    got = full(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL_TOL)
    for cnt in (block - 1, block // 2 + 12345 % (block // 2), 1000, 1):
        mask = jnp.arange(block) < cnt
        want = np.asarray(ref_partial(jnp.asarray(x), mask, jnp.int32(cnt)), np.float64)
        got = partial(torch.from_numpy(x), cnt).numpy()
        np.testing.assert_allclose(got, want, rtol=REL_TOL, err_msg=f"cnt={cnt}")


def test_histogram_accumulators_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(scale=2.0, size=50_000).astype(np.float32)
    x[:7] = [np.nan, np.inf, -np.inf, -3.0, 3.0, 2.99999, -2.99999]
    mask = rng.random(50_000) < 0.3
    histogram = (-3.0, 3.0, 37)
    ref, _ = jax_streaming._histogram_accumulators(histogram)
    counts = streaming._histogram_accumulators(histogram)
    for m in (None, mask):
        want = np.asarray(ref(jnp.asarray(x), None if m is None else jnp.asarray(m)))
        got = counts(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert counts(torch.from_numpy(x)).sum().item() == 50_000 - 1  # the NaN counts nowhere


def _carry(rng, hist_len, levels):
    total = 123_456.0
    return [
        total, 1.5, 2.75 * total, -4.0, 9.5, True,
        rng.normal(size=levels) * total, 0.25, 0.5 * total, 0.3 * total,
        rng.integers(0, 5000, size=hist_len), 0.7 * total, 11.0 * total,
    ]


@pytest.mark.parametrize("where", [False, True])
def test_finalize_estimate_matches_reference(where):
    rng = np.random.default_rng(6)
    quantiles, cvar, histogram = (0.5, 0.9), (0.99,), (-1.0, 1.0, 8)
    carry = _carry(rng, histogram[2] + 2, len(quantiles) + len(cvar))
    counts = carry[10]
    jax_carry = list(carry)
    jax_carry[10] = np.stack([counts // 2**23, counts % 2**23]).astype(np.float32)
    x = Distribution("norm")
    kwargs = dict(where=(x > 0) if where else None, control_mu=None if where else 0.2)
    want = jax_streaming._finalize_estimate(
        tuple(jax_carry), 200_000, quantiles, cvar=cvar, histogram=histogram, moments=True,
        **kwargs,
    )
    got = streaming._finalize_estimate(
        tuple(carry), 200_000, quantiles, cvar=cvar, histogram=histogram, moments=True, **kwargs
    )
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key == "histogram":
            for k in value:
                np.testing.assert_array_equal(got[key][k], value[k])
        else:
            assert got[key] == pytest.approx(value, rel=1e-12), key
    carry[5] = False
    with pytest.raises(ValueError, match="non-finite"):
        streaming._finalize_estimate(tuple(carry), 200_000, quantiles)


# --- estimate against numpy, the JAX estimate and analytic values ------


def test_estimate_matches_numpy_on_its_own_blocks():
    sink = Exp(Distribution("norm", loc=0.5, scale=0.6)) + Distribution("expon", scale=2.0)
    kwargs = dict(block_size=4096, random_state=9, executor=None)
    size = 5 * 4096 + 777
    x = sink.sample_streaming(size, **kwargs).astype(np.float64)
    st = sink.estimate(size, moments=True, **kwargs)
    want = {
        "mean": x.mean(), "var": x.var(), "min": x.min(), "max": x.max(),
        "skew": scipy.stats.skew(x), "kurt": scipy.stats.kurtosis(x),
    }
    for key, value in want.items():
        assert st[key] == pytest.approx(value, rel=REL_TOL), key
    assert st["n"] == size and st["skew"] > 1.0  # skewed: a relative test means something


def test_mixed_dag_20_agrees_with_the_jax_estimate():
    n, block = 1 << 20, 1 << 18
    jax_sink = jax_benchmarks.mixed_dag_20()
    sink = interop.from_reference(jax_sink)[jax_sink._id]
    ref = jax_streaming.estimate(jax_sink, n, block_size=block, random_state=0, executor="xla")
    got = sink.estimate(n, block_size=block, random_state=0, executor=None, moments=True)
    se_mean = np.hypot(got["sem"], ref["sem"])
    se_std = np.sqrt(2.0) * got["std"] * np.sqrt((got["kurt"] + 2.0) / (4.0 * n))
    assert abs(got["mean"] - ref["mean"]) <= 5 * se_mean
    assert abs(got["std"] - ref["std"]) <= 5 * se_std


# The analytic-value tests of tests/test_streaming_checkpoint.py's
# TestStreaming, TestNodeConvenienceMethods and neighbours that fall within
# the port's options (method=None, fixed size, no checkpoint).


def test_streamed_equals_blocked_total():
    out = streaming.sample_streaming(
        Distribution("norm", loc=2.0, scale=0.5) * 3, 10_000, block_size=1024, random_state=0
    )
    assert out.shape == (10_000,) and np.isfinite(out).all()
    assert np.isclose(out.mean(), 6.0, atol=0.05)


def test_non_block_multiple_size_and_independent_blocks():
    out = streaming.sample_streaming(Distribution("uniform"), 1000, block_size=333, random_state=1)
    assert out.shape == (1000,) and out.min() >= 0 and out.max() < 1
    out = streaming.sample_streaming(Distribution("norm"), 2048, block_size=1024, random_state=0)
    assert not np.allclose(out[:1024], out[1024:])


def test_estimate_matches_analytic():
    stats = streaming.estimate(
        Distribution("norm", loc=5, scale=2), 400_000, block_size=65_536, random_state=0
    )
    assert stats["n"] == 400_000
    assert np.isclose(stats["mean"], 5.0, atol=0.02) and np.isclose(stats["std"], 2.0, atol=0.02)
    assert stats["min"] < 0 < stats["max"]
    assert stats["sem"] == pytest.approx(stats["std"] / np.sqrt(stats["n"]), rel=1e-12)


def test_estimate_partial_last_block():
    stats = streaming.estimate(Distribution("uniform"), 1000, block_size=512, random_state=0)
    assert stats["n"] == 1000 and 0.4 < stats["mean"] < 0.6
    st = streaming.estimate(
        Distribution("uniform"), 300, block_size=1024, random_state=2, quantiles=(0.25,)
    )
    assert st["n"] == 300 and np.isclose(st["mean"], 0.5, atol=0.06)
    assert np.isclose(st["q0.25"], 0.25, atol=0.08)


def test_correlated_streaming_and_estimate():
    a, b = Distribution("norm"), Distribution("norm")
    expr = (a + b).correlate(a, b, corr_mat=np.array([[1, 0.6], [0.6, 1]]))
    out = streaming.sample_streaming(expr, 200_000, block_size=32_768, random_state=0)
    assert out.shape == (200_000,)
    assert np.isclose(out.var(), 3.2, atol=0.03) and np.isclose(out[:32_768].var(), 3.2, atol=0.03)
    a, b = Distribution("norm"), Distribution("norm")
    expr = (a + b).correlate(a, b, corr_mat=np.array([[1, -0.7], [-0.7, 1]]))
    stats = streaming.estimate(expr, 300_000, block_size=65_536, random_state=2)
    assert np.isclose(stats["std"], np.sqrt(0.6), atol=0.01)
    assert np.isclose(stats["mean"], 0.0, atol=0.01)


def test_streamed_quantiles():
    st = streaming.estimate(
        Distribution("norm", loc=5, scale=2), 400_000, block_size=65_536, random_state=0,
        quantiles=(0.5, 0.95, 0.99),
    )
    ref = scipy.stats.norm(5, 2)
    for lvl in (0.5, 0.95, 0.99):
        assert np.isclose(st[f"q{lvl:g}"], ref.ppf(lvl), atol=0.03), lvl
    st = streaming.estimate(
        Distribution("uniform"), 100_001, block_size=32_768, random_state=1, quantiles=(0.25,)
    )
    assert np.isclose(st["q0.25"], 0.25, atol=0.01)
    with pytest.raises(ValueError, match="in \\(0, 1\\)"):
        streaming.estimate(Distribution("uniform"), 1000, quantiles=(0.0,))


def test_streamed_cvar_exact_on_single_block():
    model, n = Distribution("norm"), 32_768
    st = streaming.estimate(model, n, block_size=n, random_state=3, cvar=(0.95, 0.99))
    xs = np.sort(streaming.sample_streaming(model, n, block_size=n, random_state=3))
    for q in (0.95, 0.99):
        pos = q * (n - 1)
        lo = int(pos)
        v = xs[lo] + (pos - lo) * (xs[lo + 1] - xs[lo])
        es = v + np.maximum(xs - v, 0.0).sum() / (n * (1 - q))
        assert np.isclose(st[f"cvar{q:g}"], es, rtol=1e-5), q


def test_streamed_cvar_rows_path_matches_analytic():
    bs = 1 << 18
    st = streaming.estimate(
        Distribution("norm"), 2 * bs, block_size=bs, random_state=11, quantiles=(0.9,),
        cvar=(0.95,),
    )
    z = scipy.stats.norm.ppf(0.95)
    assert np.isclose(st["cvar0.95"], scipy.stats.norm.pdf(z) / 0.05, atol=0.02)
    assert st["cvar0.95"] > st["q0.9"]


def test_streamed_histogram_exact_counts():
    model = Distribution("norm")
    n, lo, hi, bins = 10_001, -2.0, 2.0, 16
    st = streaming.estimate(model, n, block_size=1024, random_state=7, histogram=(lo, hi, bins))
    xs = streaming.sample_streaming(model, n, block_size=1024, random_state=7)
    idx = np.clip(np.floor((xs - lo) * bins / (hi - lo)), -1, bins).astype(int) + 1
    exp = np.bincount(idx, minlength=bins + 2)
    h = st["histogram"]
    np.testing.assert_array_equal(h["counts"], exp[1:-1])
    assert h["underflow"] == exp[0] and h["overflow"] == exp[-1]
    np.testing.assert_allclose(h["edges"], np.linspace(lo, hi, bins + 1))
    assert h["counts"].sum() + h["underflow"] + h["overflow"] == n


def test_streamed_histogram_composes_with_where():
    x = Distribution("norm")
    st = streaming.estimate(
        x, 5_000, block_size=1024, random_state=7, where=(x > 0), histogram=(-3.0, 3.0, 12)
    )
    h = st["histogram"]
    assert h["counts"].sum() + h["underflow"] + h["overflow"] == st["n"] < 5_000
    assert h["underflow"] == 0 and h["counts"][:6].sum() == 0
    assert st["n_total"] == 5_000 and st["acceptance"] == st["n"] / 5_000
    assert st["min"] > 0 and np.isclose(st["mean"], np.sqrt(2 / np.pi), atol=0.05)


def test_validation():
    x = Distribution("norm")
    with pytest.raises(ValueError, match="CVaR levels"):
        streaming.estimate(x, 100, block_size=64, cvar=(1.0,))
    with pytest.raises(ValueError, match="lo < hi"):
        streaming.estimate(x, 100, block_size=64, histogram=(1.0, 0.0, 5))
    with pytest.raises(ValueError, match="bins must be"):
        streaming.estimate(x, 100, block_size=64, histogram=(0, 1, 9999))
    with pytest.raises(ValueError, match="triple"):
        streaming.estimate(x, 100, block_size=64, histogram=(0, 1))
    with pytest.raises(ValueError, match="does not compose"):
        streaming.estimate(x, 100, block_size=64, where=(x > 0), cvar=(0.9,))
    with pytest.raises(ValueError, match="does not compose"):
        streaming.estimate(x, 100, block_size=64, where=(x > 0), control=(x, 0.0))
    with pytest.raises(ValueError, match="size must be >= 1"):
        streaming.estimate(x, 0, block_size=256)
    with pytest.raises(ValueError, match="size must be >= 1"):
        streaming.sample_streaming(x, 0, block_size=256)
    with pytest.raises(ValueError, match="divisible"):
        streaming.estimate(Distribution("uniform"), 100, block_size=64, replicates=3)
    with pytest.raises(ValueError, match="replicates must be >= 2"):
        streaming.estimate(Distribution("uniform"), 100, block_size=64, replicates=1)


def test_node_convenience_methods():
    stats = Distribution("norm", loc=7).estimate(50_000, block_size=8192, random_state=0)
    assert np.isclose(stats["mean"], 7.0, atol=0.05)
    out = (Distribution("uniform") * 2).sample_streaming(10_000, block_size=4096, random_state=1)
    assert out.shape == (10_000,) and 0.95 < out.mean() < 1.05


def test_streaming_raises_on_nonfinite():
    model = Log(Distribution("norm", loc=-100.0, scale=1.0))
    with pytest.raises(ValueError, match="non-finite"):
        streaming.estimate(model, 10_000, block_size=4096, random_state=0)
    with pytest.raises(ValueError, match="non-finite"):
        streaming.sample_streaming(model, 10_000, block_size=4096, random_state=0)


def test_replicates_pool_matches_single_stream_scale():
    model = Distribution("norm", loc=2.0, scale=3.0)
    pooled = streaming.estimate(model, 8192, block_size=1024, random_state=5, replicates=4)
    single = streaming.estimate(model, 8192, block_size=1024, random_state=5)
    assert pooled["replicates"] == 4 and pooled["n"] == 8192
    assert np.isclose(pooled["std"], single["std"], rtol=0.1)
    assert np.isclose(pooled["std"], 3.0, rtol=0.1)
    assert np.isclose(pooled["mean"], 2.0, atol=5 * pooled["sem"] + 1e-3)


def test_streamed_quantile_tails_and_midrange():
    st = streaming.estimate(
        Distribution("uniform"), 1 << 21, block_size=1 << 18, random_state=3,
        quantiles=(1.0 - 1e-7,),
    )
    assert st[f"q{1.0 - 1e-7:g}"] > 0.999995
    st = streaming.estimate(
        Distribution("uniform"), 1 << 19, block_size=1 << 18, random_state=4,
        quantiles=(0.5, 0.95),
    )
    assert np.isclose(st["q0.5"], 0.5, atol=0.01) and np.isclose(st["q0.95"], 0.95, atol=0.01)


def _control_model():
    z = Distribution("norm")
    noise = Distribution("norm", loc=0, scale=2.0)
    return Exp(0.3 * z) + noise, noise, float(np.exp(0.3**2 / 2))


def test_control_variates():
    model, noise, true_mean = _control_model()
    plain = streaming.estimate(model, 65536, block_size=8192, random_state=0)
    cv = streaming.estimate(model, 65536, block_size=8192, random_state=0, control=(noise, 0.0))
    assert cv["sem"] < 0.3 * plain["sem"]
    assert abs(cv["mean"] - true_mean) < 5 * cv["sem"] + 1e-3
    assert cv["control_beta"] == pytest.approx(1.0, abs=0.05) and abs(cv["control_rho"]) > 0.9
    assert cv["std"] == pytest.approx(plain["std"], abs=1e-9)
    assert cv["min"] == plain["min"] and cv["max"] == plain["max"]
    cvr = streaming.estimate(
        model, 65536, block_size=8192, random_state=0, control=(noise, 0.0), replicates=4
    )
    assert cvr["replicates"] == 4 and cvr["sem"] < 0.004
    assert abs(cvr["mean"] - true_mean) < 6 * cvr["sem"] + 2e-3
    q = (0.5, 0.9)
    a = streaming.estimate(model, 32768, block_size=8192, random_state=1, quantiles=q)
    b = streaming.estimate(
        model, 32768, block_size=8192, random_state=1, quantiles=q, control=(noise, 0.0)
    )
    assert a["q0.5"] == b["q0.5"] and a["q0.9"] == b["q0.9"]
    with pytest.raises(ValueError, match="pair"):
        streaming.estimate(model, 100, block_size=64, control=noise)
    with pytest.raises(ValueError, match="graph node"):
        streaming.estimate(model, 100, block_size=64, control=(3.0, 0.0))


def test_sibling_and_disjoint_controls():
    z = Distribution("norm")
    sink = Exp(0.2 * z)
    control = 3.0 * z  # a sibling: rooted with the sink under one NoOp
    cv = streaming.estimate(sink, 32768, block_size=8192, random_state=0, control=(control, 0.0))
    plain = streaming.estimate(sink, 32768, block_size=8192, random_state=0)
    assert abs(cv["control_rho"]) > 0.9 and cv["sem"] < 0.5 * plain["sem"]
    assert abs(cv["mean"] - np.exp(0.02)) < 5 * cv["sem"] + 1e-3
    model, _, true_mean = _control_model()
    cv = streaming.estimate(
        model, 16384, block_size=4096, random_state=3, control=(Distribution("norm"), 0.0)
    )
    assert abs(cv["control_beta"]) < 0.15 and abs(cv["mean"] - true_mean) < 0.05


# --- Options, executors and the kernels' start ------------------------


@pytest.mark.parametrize(
    "option",
    ["method", "target_sem", "target_rel_sem", "max_size", "checkpoint", "estimate_many",
     "streamed_method"],
)
def test_options_out_of_scope_raise(option, tmp_path):
    """Every option here raised until it was ported; now each runs
    (``tests/test_torch_sequential.py``, ``tests/test_torch_qmc_streaming.py``,
    ``tests/test_torch_estimate_many.py`` and
    ``tests/test_torch_sequential_many.py`` hold them to the analytic values
    and to ``sample``) and a checkpoint without a ``random_state`` is
    refused (R3)."""
    s = Distribution("norm", loc=3.0)
    if option == "estimate_many":
        st = streaming.estimate_many([s], 4096, block_size=1024, method="sobol", random_state=0)[s]
        assert st["n"] == 4096 and abs(st["mean"] - 3.0) < 1e-2
    elif option == "method":
        st = streaming.estimate(s, 4096, block_size=1024, method="sobol", random_state=0)
        assert st["n"] == 4096 and abs(st["mean"] - 3.0) < 1e-2
    elif option == "streamed_method":
        out = streaming.sample_streaming(s, 100, block_size=64, method="lhs", random_state=0)
        np.testing.assert_array_equal(out, s.sample(100, random_state=0, method="lhs").numpy())
    elif option == "target_sem":
        st = streaming.estimate(s, 100, target_sem=0.1, random_state=0)
        assert st["converged"] and st["sem"] <= 0.1 and st["rounds"] >= 1
    elif option == "target_rel_sem":
        st = streaming.estimate(s, 100, target_rel_sem=0.01, random_state=0)
        assert st["converged"] and st["sem"] <= 0.01 * abs(st["mean"])
    elif option == "max_size":  # without a target, a fixed-size run
        st = streaming.estimate(s, 100, max_size=1000, random_state=0)
        assert st["n"] == 100 and "rounds" not in st
    else:
        path = tmp_path / "run.npz"
        with pytest.raises(ValueError, match="random_state"):
            streaming.estimate(s, 100, checkpoint=str(path))
        st = streaming.estimate(s, 100, checkpoint=str(path), random_state=0)
        assert st["n"] == 100 and not path.exists()


def test_executor_resolution():
    sink = benchmarks.mixed_dag_20()
    plan = tcompile.get_plan(sink)
    keep = frozenset({sink._id})
    assert streaming._resolve_executor(plan, keep, "auto", "imanconover") is None  # the CPU
    with pytest.raises(ValueError, match="executor='cuda'"):
        streaming._resolve_executor(plan, keep, "pallas", "imanconover")
    with pytest.raises(ValueError, match="CUDA device|config.device"):
        streaming.estimate(sink, 1024, block_size=512, executor="cuda")  # no fallback
    with pytest.raises(ValueError, match="Unknown executor"):
        streaming.estimate(sink, 1024, block_size=512, executor="xla")
    corr = tcompile.get_plan(benchmarks.mixed_correlated_50())
    with pytest.raises(ValueError, match="imanconover"):
        streaming._resolve_executor(corr, frozenset({corr.sink._id}), "cuda", "cholesky")
    assert streaming._resolve_executor(corr, frozenset({corr.sink._id}), "auto", "cholesky") is None
    config.set_device("cuda")  # a CUDA device the kernels cannot use here: raise, never fall back
    with pytest.raises(RuntimeError, match="CUDA device"):
        streaming._resolve_executor(plan, keep, "auto", "imanconover")


def test_auto_on_the_cpu_equals_the_plain_executor():
    sink = benchmarks.mixed_dag_20()
    a = sink.estimate(3000, block_size=1024, random_state=4, executor="auto")
    b = sink.estimate(3000, block_size=1024, random_state=4, executor=None)
    assert a == b


def test_start_addresses_one_long_twin_stream():
    sink = benchmarks.mixed_correlated_50()
    plan = tcompile.get_plan(sink)
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, {sink._id}))
    words, B = cuda_exec.seed_words(21), 4096
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    ab = cuda_exec.recolor_transform(plan, words, B, device="cpu")
    U = cuda_exec.philox_uniforms(words, 3 * B, plan.d)
    # start=0 is the twin as it was: the bits of samples 0.., the same tape.
    torch.testing.assert_close(
        cuda_exec.run_reference(tape, words, B, ab, start=0),
        cuda_exec.run_tape(tape, U[:B], ab), rtol=0, atol=0,
    )
    long = cuda_exec.run_reference(tape, words, 3 * B, ab)
    for b in range(3):
        got, _ = cuda_exec.run(tape, words, B, ab, start=b * B)  # a CPU tape: the twin
        torch.testing.assert_close(got, long[:, b * B : (b + 1) * B], rtol=0, atol=0)
        sums = cuda_exec.corr_stats(words, B, columns, "cpu", start=b * B)
        z = cuda_exec._special.ndtri_fast(U[b * B : (b + 1) * B][:, columns]).double()
        iu = torch.triu_indices(len(columns), len(columns))
        torch.testing.assert_close(sums[: len(columns)], z.sum(dim=0), rtol=1e-12, atol=1e-9)
        torch.testing.assert_close(sums[len(columns) :], (z.T @ z)[iu[0], iu[1]], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(
        cuda_exec.corr_stats_reference(words, B, columns, start=0, chunk=1000),
        cuda_exec.corr_stats_reference(words, B, columns),
    )


def test_device_solve_matches_the_numpy_twin():
    plan = tcompile.get_plan(benchmarks.mixed_correlated_50())
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    sums = cuda_exec.corr_stats_reference((3, 4), 20_000, columns, start=7 * 20_000)
    P = cuda_exec._correlation.ImanConover().set_target(plan.corr_matrix).P
    got = cuda_exec.solve_recolor_device(sums, 20_000, P).numpy()
    want = cuda_exec.solve_recolor(sums.numpy(), 20_000, plan.corr_matrix)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_recolor_transform_solves_alike_on_the_host_and_the_device():
    plan = tcompile.get_plan(benchmarks.mixed_correlated_50())
    words, B = cuda_exec.seed_words(9), 8192
    host = cuda_exec.recolor_transform(plan, words, B, "cpu", start=2 * B, solve="host")
    device = cuda_exec.recolor_transform(plan, words, B, "cpu", start=2 * B, solve="device")
    assert host.dtype == device.dtype == torch.float32
    torch.testing.assert_close(host, device, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="solve"):
        cuda_exec.recolor_transform(plan, words, B, "cpu", solve="gpu")
