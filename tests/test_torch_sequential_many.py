"""Sequential and checkpointed ``estimate_many`` of the port, on the CPU.

Ports of the JAX package's ``TestSequentialEstimateMany``,
``TestSequentialReplicatedMany`` and ``TestStreamCheckpointMany``
(``tests/test_streaming_checkpoint.py``) against the same analytic values.
Beside them: the rounds' and replicates' seeds (each its own stream, as in
the port's ``estimate``), the segments folding the blocks of the one
uninterrupted stream, a reordered node list refused on resume, R3's refusal
(a checkpoint needs an explicit ``random_state``), and a non-finite run
keeping its checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import streaming
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.models.graph import Log
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


# --- TestSequentialEstimateMany --------------------------------------------------------


def test_all_nodes_converge_worst_binds():
    a = Distribution("norm", loc=1.0, scale=1.0)
    b = Distribution("norm", loc=0.0, scale=5.0)
    total = a + b
    out = streaming.estimate_many([a, b, total], 2048, block_size=1024, random_state=0,
                                  target_sem=0.05)
    assert all(v["converged"] and v["sem"] <= 0.05 for v in out.values())
    # One shared stream: every node reports the same n and rounds.
    assert len({v["n"] for v in out.values()}) == 1
    assert len({v["rounds"] for v in out.values()}) == 1
    # The worst node (total, var ~26) sizes the run: n ~ 1.2 * 26 / 0.05^2.
    n = next(iter(out.values()))["n"]
    assert 26 / 0.05**2 < n < 4.0 * 26 / 0.05**2
    assert abs(out[total]["mean"] - 1.0) < 5 * out[total]["sem"]


def test_consistent_with_single_sink_rules():
    a = Distribution("norm")
    with pytest.raises(ValueError, match=">= 2"):
        streaming.estimate_many([a], 1024, target_sem=0.1, replicates=1, random_state=0)
    out = streaming.estimate_many([a], 1024, block_size=512, target_sem=0.1, replicates=2,
                                  random_state=0)
    assert out[a]["converged"] is True and out[a]["replicates"] == 2
    with pytest.raises(ValueError, match="QMC error bar"):
        streaming.estimate_many([a], 1024, target_sem=0.1, method="lhs", random_state=0)
    with pytest.raises(ValueError, match="max_size"):
        streaming.estimate_many([a], 1024, target_sem=0.1, max_size=4, random_state=0)
    with pytest.raises(ValueError, match="must be > 0"):
        streaming.estimate_many([a], 1024, target_rel_sem=0.0, random_state=0)


def test_cap_reports_unconverged():
    a = Distribution("norm")
    out = streaming.estimate_many([a, a + 1.0], 512, block_size=512, random_state=1,
                                  target_sem=1e-7, max_size=1024)
    assert all(v["converged"] is False for v in out.values())
    assert all(v["n"] == 1024 for v in out.values())


def test_composes_with_where_and_quantiles():
    x = Distribution("norm")
    y = x * 2.0
    out = streaming.estimate_many([x, y], 4096, block_size=1024, random_state=2,
                                  where=(x > 0.0), target_sem=0.03)
    assert all(v["converged"] for v in out.values())
    assert abs(out[x]["mean"] - np.sqrt(2 / np.pi)) < 5 * out[x]["sem"]
    assert abs(out[y]["mean"] - 2 * out[x]["mean"]) < 1e-6
    outq = streaming.estimate_many([x, y], 2048, block_size=1024, random_state=3,
                                   target_sem=0.05, quantiles=(0.5,))
    assert all("q0.5" in v and v["converged"] for v in outq.values())


def test_relative_target_and_control():
    x = Distribution("norm", loc=10.0, scale=2.0)
    c = Distribution("norm")
    y = x + 3.0 * c
    out = streaming.estimate_many([x, y], 1024, block_size=512, random_state=4,
                                  target_rel_sem=0.005, control=(c, 0.0))
    for node in (x, y):
        assert out[node]["converged"] and out[node]["sem"] <= 0.005 * abs(out[node]["mean"])
    assert out[y]["control_beta"] == pytest.approx(3.0, abs=0.1)


def test_rounds_and_replicates_draw_their_own_streams(monkeypatch):
    seeds = []
    real = streaming._many_carry
    monkeypatch.setattr(streaming, "_many_carry",
                        lambda nodes, size, block, seed, *a, **k: seeds.append(seed)
                        or real(nodes, size, block, seed, *a, **k))
    x = Distribution("norm", loc=1.0, scale=2.0)
    out = streaming.estimate_many([x, x * 0.5], 256, block_size=256, random_state=5,
                                  target_sem=0.02)
    rounds = out[x]["rounds"]
    assert rounds > 2 and len(set(seeds)) == len(seeds) == rounds
    assert seeds == [streaming._derive_seed(5, 2, r) for r in range(rounds)]
    seeds.clear()
    out = streaming.estimate_many([x, x * 0.5], 512, block_size=256, random_state=5,
                                  target_sem=0.05, replicates=2)
    assert seeds == [streaming._derive_seed(5, 3, r, k)
                     for k in range(out[x]["rounds"]) for r in (0, 1)]


def test_rounds_share_one_program():
    x = Distribution("norm", loc=1.0)
    y = x + 1.0
    streaming.estimate_many([x, y], 512, block_size=256, random_state=1, target_sem=0.5)
    builds = streaming._MANY_BUILDS
    out = streaming.estimate_many([x, y], 512, block_size=256, random_state=1, target_sem=0.02)
    assert out[x]["rounds"] > 1 and streaming._MANY_BUILDS == builds


def test_where_that_never_holds():
    x = Distribution("norm")
    with pytest.raises(ValueError, match="never held"):
        streaming.estimate_many([x], 256, block_size=256, random_state=0, where=x > 50.0,
                                target_sem=0.1, max_size=1024)


# --- TestSequentialReplicatedMany ------------------------------------------------------


def test_sobol_sequential_many_converges():
    a = Distribution("norm", loc=2.0, scale=3.0)
    b = a + Distribution("norm", loc=0.0, scale=1.0)
    out = streaming.estimate_many([a, b], 4096, block_size=1024, random_state=0, method="sobol",
                                  target_sem=0.01, replicates=4)
    for node in (a, b):
        assert out[node]["converged"] is True
        assert out[node]["sem"] <= 0.01
        assert out[node]["replicates"] == 4
    assert abs(out[a]["mean"] - 2.0) < 6 * out[a]["sem"] + 1e-6
    assert abs(out[b]["mean"] - 2.0) < 6 * out[b]["sem"] + 1e-6


def test_qmc_without_replicates_still_rejected():
    a = Distribution("norm")
    with pytest.raises(ValueError, match="QMC error bar"):
        streaming.estimate_many([a], 1024, target_sem=0.1, method="sobol", random_state=0)


# --- TestStreamCheckpointMany ----------------------------------------------------------


def _run(nodes, path, **kw):
    return streaming.estimate_many(nodes, 10_000, block_size=1024, random_state=0,
                                   checkpoint=str(path), checkpoint_every=2048, **kw)


def _dying_after(monkeypatch, segments):
    """Make ``_many_carry`` raise after ``segments`` calls."""
    real = streaming._many_carry
    calls = {"n": 0}

    def dying(*a, **k):
        if calls["n"] >= segments:
            raise RuntimeError("simulated crash")
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(streaming, "_many_carry", dying)
    return real


def test_killed_run_resumes_bitwise_identically(tmp_path, monkeypatch):
    a = Distribution("norm", loc=1.0, scale=2.0)
    b = a * a
    p = tmp_path / "many.ckpt.npz"
    kw = dict(covariance=True, moments=True, quantiles=(0.9,), histogram=(-5.0, 20.0, 10))
    full = _run([a, b], p, **kw)
    assert not os.path.exists(p)
    real = _dying_after(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _run([a, b], p, **kw)
    monkeypatch.setattr(streaming, "_many_carry", real)
    assert p.exists()
    resumed = _run([a, b], p, **kw)
    for node in (a, b):
        for k in ("n", "mean", "var", "sem", "min", "max", "skew", "kurt", "q0.9"):
            assert resumed[node][k] == full[node][k], k
        np.testing.assert_array_equal(resumed[node]["cov"], full[node]["cov"])
        np.testing.assert_array_equal(resumed[node]["histogram"]["counts"],
                                      full[node]["histogram"]["counts"])
    assert not p.exists()


def test_mismatched_node_order_refused(tmp_path, monkeypatch):
    a = Distribution("norm", loc=1.0, scale=2.0)
    b = Distribution("expon", scale=1.0)
    p = tmp_path / "many.ckpt.npz"
    real = _dying_after(monkeypatch, 1)
    with pytest.raises(RuntimeError):
        _run([a, b], p)
    monkeypatch.setattr(streaming, "_many_carry", real)
    assert p.exists()
    with pytest.raises(ValueError, match="different run"):
        _run([b, a], p)
    with pytest.raises(ValueError, match="different run"):  # covariance is part of the run
        _run([a, b], p, covariance=True)
    assert _run([a, b], p)[a]["n"] == 10_000  # the right run resumes


def test_composition_errors(tmp_path):
    a = Distribution("norm")
    with pytest.raises(ValueError, match="checkpoint"):
        streaming.estimate_many([a], 1024, checkpoint=str(tmp_path / "c.npz"), replicates=2,
                                random_state=0)
    with pytest.raises(ValueError, match="checkpoint"):
        streaming.estimate_many([a], 1024, checkpoint=str(tmp_path / "c.npz"), target_sem=0.1,
                                random_state=0)
    with pytest.raises(ValueError, match="checkpoint_every"):
        streaming.estimate_many([a], 1024, checkpoint_every=512)


def test_checkpoint_needs_an_explicit_random_state(tmp_path):
    """R3: fresh entropy never matches the saved fingerprint, so a run
    seeded from it could never resume; the port refuses it."""
    with pytest.raises(ValueError, match="random_state"):
        streaming.estimate_many([Distribution("norm")], 1024, checkpoint=str(tmp_path / "c.npz"))
    assert not (tmp_path / "c.npz").exists()


def test_non_finite_run_keeps_its_checkpoint(tmp_path):
    p = tmp_path / "bad.npz"
    x = Distribution("norm", loc=-100.0, scale=1.0)
    with pytest.raises(ValueError, match="non-finite"):
        _run([x, Log(x)], p)
    assert p.exists()


def test_segments_fold_the_blocks_of_one_stream(tmp_path):
    """The checkpointed run's segments are windows of the one stream: the
    same count, extremes and histograms as an uninterrupted run, the
    means to rounding."""
    x = Distribution("uniform")
    y = x * 3.0 - 1.0
    kw = dict(histogram=(-1.0, 2.0, 12))
    plain = streaming.estimate_many([x, y], 10_000, block_size=1024, random_state=0, **kw)
    ck = _run([x, y], tmp_path / "c.npz", **kw)
    for node in (x, y):
        assert (ck[node]["n"], ck[node]["min"], ck[node]["max"]) == (
            plain[node]["n"], plain[node]["min"], plain[node]["max"])
        np.testing.assert_array_equal(ck[node]["histogram"]["counts"],
                                      plain[node]["histogram"]["counts"])
        assert ck[node]["mean"] == pytest.approx(plain[node]["mean"], rel=1e-12)
    whole = streaming._many_carry([x, y], 5000, 1024, 11, "auto")
    parts = [streaming._many_carry([x, y], 5000, 1024, 11, "auto", block_lo=0, n_blocks=3,
                                   last_count=1024),
             streaming._many_carry([x, y], 5000, 1024, 11, "auto", block_lo=3, n_blocks=2,
                                   last_count=5000 - 4 * 1024)]
    merged, _ = streaming._merge_many_carries(parts)
    assert float(merged[0]) == float(whole[0]) == 5000
    torch.testing.assert_close(merged[3], whole[3].cpu(), rtol=0, atol=0)
    torch.testing.assert_close(merged[1], whole[1].cpu(), rtol=1e-12, atol=0)
