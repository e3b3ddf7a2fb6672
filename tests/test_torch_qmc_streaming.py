"""``method=`` through ``sample``, ``sample_streaming`` and every form of
``estimate`` in the port, on the CPU.

``sample_streaming(method=m)`` equals ``sample(method=m)`` bit for bit
(block b is points ``[b*B, b*B + B)`` of the one sequence; LHS stratifies
over the whole run); replicated runs re-randomise each replicate;
sequential runs under a QMC method need ``replicates`` and round LHS
chunks to powers of two; checkpointed runs resume bitwise with the method
in the fingerprint.  The refusals are the JAX package's: an unknown
method, a run past the method's index cap, a correlated graph, a
column-seeded node, a vector-valued sink or condition, and
``executor="cuda"``.  Ports of the QMC cases of the JAX package's
``tests/test_streaming_checkpoint.py`` (``TestStreamedQMC``, the
replicated and sequential QMC cases, the QMC checkpoint) sit beside them.
"""

import numpy as np
import pytest
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import streaming
from probabilit_tpu_torch.models.benchmarks import mixed_dag_20
from probabilit_tpu_torch.models.distributions import Distribution, MultivariateDistribution
from probabilit_tpu_torch.models.factories import ClaytonCopula
from probabilit_tpu_torch.models.graph import Exp
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

METHODS = ["sobol", "halton", "lhs", "antithetic"]


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.mark.parametrize("method", METHODS)
def test_streamed_mixed_dag_equals_single_shot(method):
    """The flagship graph: a partial last block, and blocks that split an
    antithetic pair."""
    sink = mixed_dag_20()
    single = sink.sample(3000, random_state=5, method=method).numpy()
    for block in (1024, 300):
        streamed = streaming.sample_streaming(sink, 3000, block_size=block, random_state=5,
                                              method=method)
        np.testing.assert_array_equal(single, streamed)


@pytest.mark.parametrize("method", METHODS)
def test_streamed_estimate_folds_the_single_shot_points(method):
    x = Distribution("norm", loc=1.0, scale=2.0)
    cond = x > 2.0
    size, bs = 10_000, 2048  # a partial final block
    full = x.sample(size, random_state=3, method=method).numpy().astype(np.float64)
    st = streaming.estimate(x, size, block_size=bs, random_state=3, method=method)
    assert st["mean"] == pytest.approx(full.mean(), rel=1e-12, abs=1e-12)
    assert st["var"] == pytest.approx(full.var(), rel=1e-10)
    assert st["min"] == full.min() and st["max"] == full.max()
    res = streaming.estimate(x, size, block_size=bs, random_state=3, method=method, where=cond)
    kept = full[full > 2.0]
    assert res["n"] == kept.size and res["mean"] == pytest.approx(kept.mean(), rel=1e-12)


def test_streamed_incomplete_families_equal_single_shot():
    """Newton ppfs freeze each lane on its own, so blocks hold bitwise."""
    for fam, kw in [("gamma", dict(a=2.0)), ("chi2", dict(df=5.0)),
                    ("beta", dict(a=2.5, b=3.5)), ("t", dict(df=3.0)), ("beta", dict(a=0.5, b=0.5))]:
        expr = Distribution(fam, **kw)
        single = expr.sample(2048, random_state=0, method="sobol").numpy()
        streamed = streaming.sample_streaming(expr, 2048, block_size=512, random_state=0,
                                              method="sobol")
        np.testing.assert_array_equal(single, streamed, err_msg=fam)


def test_streamed_lhs_large_bitwise():
    expr = Distribution("uniform")
    n = 1 << 18
    single = expr.sample(n, random_state=0, method="lhs").numpy()
    streamed = streaming.sample_streaming(expr, n, block_size=1 << 16, random_state=0, method="lhs")
    np.testing.assert_array_equal(single, streamed)


def test_estimate_with_sobol_and_lhs():
    st = streaming.estimate(Distribution("norm", loc=7.0), 100_000, block_size=16384,
                            random_state=0, method="sobol")
    assert abs(st["mean"] - 7.0) < 1e-3  # QMC error decays ~1/n
    st = streaming.estimate(Distribution("uniform"), 100_000, block_size=16384, random_state=1,
                            method="lhs")
    assert abs(st["mean"] - 0.5) < 1e-4


def test_lhs_estimate_size_sweep_stratifies_each_size():
    model = Distribution("uniform")
    streaming.estimate(model, 2048, block_size=1024, random_state=7, method="lhs")
    st = streaming.estimate(model, 8192, block_size=1024, random_state=7, method="lhs")
    single = model.sample(8192, random_state=7, method="lhs").numpy().astype(np.float64).mean()
    assert abs(st["mean"] - single) < 1e-12


def test_rqmc_sem_beats_iid_sem():
    model = Distribution("norm", loc=3.0) + Distribution("uniform")
    iid = streaming.estimate(model, 65536, block_size=8192, random_state=0)
    rq = streaming.estimate(model, 65536, block_size=8192, random_state=0, method="sobol",
                            replicates=8)
    assert rq["replicates"] == 8 and rq["sem"] < 0.2 * iid["sem"]
    assert abs(rq["mean"] - 3.5) < 6 * rq["sem"] + 1e-4


def test_antithetic_replicates_collapse_sem():
    model = Distribution("norm") + Distribution("uniform")
    iid = streaming.estimate(model, 16384, block_size=2048, random_state=3)
    anti = streaming.estimate(model, 16384, block_size=2048, random_state=3, method="antithetic",
                              replicates=4)
    assert anti["sem"] < 0.05 * iid["sem"]


def test_replicates_are_re_randomised(monkeypatch):
    """Replicate r runs the method under ``_derive_seed(seed, 1, r)``."""
    seeds = []
    real = streaming._estimate_carry
    monkeypatch.setattr(streaming, "_estimate_carry",
                        lambda sink, size, bs, seed, *a, **k: seeds.append(seed) or real(
                            sink, size, bs, seed, *a, **k))
    streaming.estimate(Distribution("norm"), 4096, block_size=1024, random_state=9,
                       method="halton", replicates=4)
    assert seeds == [streaming._derive_seed(9, 1, r) for r in range(4)]


def test_sequential_qmc_needs_replicates():
    x = Distribution("norm")
    for m in ("sobol", "halton", "lhs"):
        with pytest.raises(ValueError, match="QMC error bar"):
            streaming.estimate(x, 1024, target_sem=0.1, method=m, random_state=0)


def test_sequential_antithetic_allowed_and_converges():
    x = Distribution("norm", loc=5.0)
    st = streaming.estimate(x, 1024, block_size=512, random_state=6, method="antithetic",
                            target_sem=0.05)
    assert st["converged"] and st["sem"] <= 0.05
    assert abs(st["mean"] - 5.0) < 5 * st["sem"] + 1e-9


def test_sobol_sequential_replicated_converges():
    x = Distribution("norm", loc=2.0, scale=3.0)
    st = streaming.estimate(x, 4096, block_size=1024, random_state=0, method="sobol",
                            target_sem=0.01, replicates=4)
    assert st["converged"] is True and st["sem"] <= 0.01
    assert st["replicates"] == 4 and st["rounds"] >= 1
    assert abs(st["mean"] - 2.0) < 6 * st["sem"] + 1e-6


def test_sequential_replicated_sem_is_valid_against_independent_runs():
    y = Exp(Distribution("norm"))
    st = streaming.estimate(y, 8192, block_size=2048, random_state=1, method="sobol",
                            target_sem=5e-4, replicates=4, max_size=1 << 17)
    singles = [
        streaming.estimate(y, st["n"] // 4, block_size=2048, random_state=100 + i,
                           method="sobol")["mean"]
        for i in range(16)
    ]
    truth_sd = float(np.std(singles, ddof=1))
    assert 0.3 * truth_sd < st["sem"] * 2.0 < 3.0 * truth_sd
    assert abs(st["mean"] - np.exp(0.5)) < 6 * st["sem"] + 1e-5


def test_lhs_sequential_rounds_are_powers_of_two(monkeypatch):
    sizes = []
    real = streaming._estimate_carry
    monkeypatch.setattr(streaming, "_estimate_carry",
                        lambda sink, size, *a, **k: sizes.append(size) or real(sink, size, *a, **k))
    x = Distribution("norm", loc=2.0, scale=3.0)
    st = streaming.estimate(Exp(x * 0.3), 4096, block_size=1024, random_state=0, method="lhs",
                            target_sem=2e-4, replicates=4, max_size=1 << 17)
    assert st["rounds"] > 1 and st["replicates"] == 4
    rounds = sizes[::4]
    assert sizes == [r for r in rounds for _ in range(4)]
    # Every round a power of two but a last one clamped to the budget left.
    assert all(r & (r - 1) == 0 for r in rounds[:-1]), rounds
    assert rounds[-1] & (rounds[-1] - 1) == 0 or 4 * sum(rounds) == st["n"] == 1 << 17


def test_round_chunk_quantizes_lhs_only():
    rc = streaming._round_chunk
    assert rc(1000, 10**9, "lhs") == 1024
    assert rc(1024, 10**9, "lhs") == 1024
    assert rc(1025, 10**9, "lhs") == 2048
    assert rc(1, 10**9, "lhs") == 1 and rc(0, 10**9, "lhs") == 1
    assert rc(1000, 600, "lhs") == 600  # the budget wins over the power of two
    for m in ("sobol", "halton", "antithetic", None):
        assert rc(1000, 10**9, m) == 1000


def test_checkpointed_qmc_resumes_bitwise(tmp_path, monkeypatch):
    x = Distribution("norm", loc=0.0, scale=1.0)
    path = tmp_path / "q.ckpt.npz"
    kw = dict(block_size=1024, random_state=0, quantiles=(0.5,), checkpoint=str(path),
              checkpoint_every=2048)
    for m in ("sobol", "lhs"):
        full = streaming.estimate(x, 8192, method=m, **kw)
        plain = streaming.estimate(x, 8192, block_size=1024, random_state=0, method=m)
        assert abs(full["mean"] - plain["mean"]) < 1e-12
        real, calls = streaming._estimate_carry, []

        def dying(*args, **kwargs):
            if len(calls) == 2:
                raise KeyboardInterrupt
            calls.append(1)
            return real(*args, **kwargs)

        monkeypatch.setattr(streaming, "_estimate_carry", dying)
        with pytest.raises(KeyboardInterrupt):
            streaming.estimate(x, 8192, method=m, **kw)
        monkeypatch.setattr(streaming, "_estimate_carry", real)
        assert path.exists()
        if m == "sobol":  # the method is in the fingerprint
            with pytest.raises(ValueError, match="different run"):
                streaming.estimate(x, 8192, method="halton", **kw)
        resumed = streaming.estimate(x, 8192, method=m, **kw)
        assert resumed == full and not path.exists()


def test_streamed_qmc_refusals():
    x = Distribution("norm")
    with pytest.raises(ValueError, match="index-addressable"):
        streaming.sample_streaming(x, 100, method="bogus")
    with pytest.raises(ValueError, match="at most 2\\^32"):
        streaming.sample_streaming(x, 2**32 + 1, method="sobol")
    with pytest.raises(ValueError, match="at most 2\\^31"):
        streaming.estimate(x, 2**31 + 1, method="halton")
    a, b = Distribution("norm"), Distribution("norm")
    corr = (a + b).correlate(a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
    with pytest.raises(ValueError, match="correlation-free"):
        streaming.sample_streaming(corr, 100, block_size=64, method="sobol")
    for m in METHODS:
        with pytest.raises(ValueError, match="executor='cuda' requires method=None"):
            streaming.estimate(x, 100, executor="cuda", method=m)
    with pytest.raises(ValueError, match="executor='cuda'"):
        streaming.sample_streaming(x, 100, executor="pallas", method="sobol")


def test_streamed_method_rejected_for_column_seeded_nodes():
    u1, u2 = ClaytonCopula(theta=2.0)
    with pytest.raises(ValueError, match="column-seeded"):
        streaming.estimate(u1 + u2, 256, block_size=64, method="antithetic")
    d1, _ = MultivariateDistribution("dirichlet", alpha=[1.0, 2.0])
    with pytest.raises(ValueError, match="column-seeded"):
        streaming.estimate(d1, 256, block_size=64, method="sobol")
    out = streaming.sample_streaming(u1 + u2, 256, block_size=64, random_state=0)
    assert out.shape == (256,)  # method=None streams stay allowed


def test_streaming_rejects_vector_valued_sinks_and_conditions():
    u1, _ = ClaytonCopula(theta=2.0)
    with pytest.raises(ValueError, match="vector-valued"):
        streaming.estimate(u1.distr, 256, block_size=64)
    with pytest.raises(ValueError, match="vector-valued"):
        streaming.sample_streaming(u1.distr, 256, block_size=64)
    with pytest.raises(ValueError, match="vector-valued"):
        streaming.estimate(u1, 256, block_size=64, where=u1.distr)


def test_sample_methods_run_on_the_configured_device():
    out = mixed_dag_20().sample(256, random_state=0, method="sobol")
    assert out.device == config.device() and out.dtype == torch.float32
