"""Sequential and checkpointed ``estimate``, and graph checkpoints, on the CPU.

Ports of the JAX package's ``TestSequentialEstimate``,
``TestSequentialReplicated``, ``TestStreamCheckpoint``, ``TestCheckpoint``
and ``TestCheckpointFingerprint`` (``tests/test_streaming_checkpoint.py``)
against the same analytic values, without their QMC cases (ROADMAP A9) and
the scalar-function fingerprints (A10).  Beside them: the rounds' and
replicates' seeds (each its own stream), the block windows of a
checkpointed segment (the draws of the uninterrupted run), R3's refusal,
and a non-finite run keeping its checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import checkpoint, cuda_exec, streaming
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.models.graph import Constant, Exp, Log
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


# --- TestSequentialEstimate -------------------------------------------------------------


def test_converges_to_target():
    x = Distribution("norm", loc=2.0, scale=3.0)
    st = streaming.estimate(x, 2048, block_size=1024, random_state=0, target_sem=0.02)
    assert st["converged"] is True
    assert st["sem"] <= 0.02
    assert st["rounds"] > 1 and st["n"] > 2048
    # Two-stage sizing lands near n = 1.2 (std/target)^2, never far past it.
    assert st["n"] < 4.0 * (3.0 / 0.02) ** 2
    assert abs(st["mean"] - 2.0) < 5 * st["sem"] + 1e-9


def test_rounds_share_one_program(monkeypatch):
    """Every round and replicate runs the one lowered tape (sizes are
    arguments, not structure): the kernels' path, here through the twin."""
    monkeypatch.setattr(streaming, "_resolve_executor", lambda *args: "cuda")
    lowered = []
    real = cuda_exec.lower
    monkeypatch.setattr(cuda_exec, "lower", lambda *a: lowered.append(1) or real(*a))
    x = Distribution("norm", loc=1.0)
    st = streaming.estimate(x, 512, block_size=256, random_state=1, target_sem=0.02)
    assert st["converged"] and st["rounds"] > 1 and len(lowered) == 1
    st = streaming.estimate(x, 512, block_size=256, random_state=1, target_sem=0.02, replicates=2)
    assert st["converged"] and st["rounds"] > 1 and len(lowered) == 1


def test_rounds_and_replicates_draw_their_own_streams(monkeypatch):
    """On the kernels block b of a seed is samples b*B.. of one Philox
    stream, so every round and every replicate must have its own seed."""
    seeds = []
    real = streaming._estimate_carry
    monkeypatch.setattr(streaming, "_estimate_carry",
                        lambda sink, size, block, seed, *a, **k: seeds.append(seed)
                        or real(sink, size, block, seed, *a, **k))
    x = Distribution("norm", loc=1.0, scale=2.0)
    st = streaming.estimate(x, 256, block_size=256, random_state=5, target_sem=0.02)
    assert st["rounds"] > 2 and len(set(seeds)) == len(seeds) == st["rounds"]
    assert seeds == [streaming._derive_seed(5, 2, r) for r in range(st["rounds"])]
    seeds.clear()
    st = streaming.estimate(x, 512, block_size=256, random_state=5, target_sem=0.05, replicates=2)
    assert seeds == [streaming._derive_seed(5, 3, r, k) for k in range(st["rounds"]) for r in (0, 1)]
    seeds.clear()
    streaming.estimate(x, 512, block_size=256, random_state=5, replicates=2)
    assert seeds == [streaming._derive_seed(5, 1, r) for r in (0, 1)]


def test_relative_target():
    x = Distribution("norm", loc=10.0, scale=2.0)
    st = streaming.estimate(x, 1024, block_size=512, random_state=2, target_rel_sem=0.01)
    assert st["converged"] and st["sem"] <= 0.01 * abs(st["mean"])


def test_max_size_cap():
    x = Distribution("norm")
    st = streaming.estimate(
        x, 1024, block_size=1024, random_state=1, target_sem=1e-7, max_size=4096
    )
    assert st["converged"] is False
    assert st["n"] == 4096 and st["sem"] > 1e-7


def test_constant_sink_converges_in_one_round():
    node = Constant(4.0) + Distribution("uniform") * 0.0
    st = streaming.estimate(node, 512, block_size=256, random_state=0, target_sem=1e-9)
    assert st["converged"] and st["rounds"] == 1
    assert st["mean"] == pytest.approx(4.0)


def test_composes_with_where():
    x = Distribution("norm")
    st = streaming.estimate(
        x, 4096, block_size=1024, random_state=3, where=(x > 0.0), target_sem=0.02
    )
    assert st["converged"] and st["sem"] <= 0.02
    assert abs(st["mean"] - np.sqrt(2 / np.pi)) < 5 * st["sem"] + 1e-9  # E[Z | Z > 0]
    assert 0.3 < st["acceptance"] < 0.7
    assert st["n_total"] >= st["n"]


def test_control_variate_shrinks_required_n():
    y = Distribution("norm", loc=0.0, scale=1.0)
    x = y + 0.1 * Distribution("norm", loc=1.0)
    plain = streaming.estimate(x, 1024, block_size=512, random_state=4, target_sem=0.01)
    ctl = streaming.estimate(
        x, 1024, block_size=512, random_state=4, target_sem=0.01, control=(y, 0.0)
    )
    assert ctl["converged"] and ctl["sem"] <= 0.01
    assert ctl["n"] < 0.25 * plain["n"]


def test_quantiles_and_histogram_ride_along():
    x = Distribution("norm")
    st = streaming.estimate(
        x, 2048, block_size=1024, random_state=5, target_sem=0.02, quantiles=(0.5,),
        histogram=(-4.0, 4.0, 16),
    )
    assert st["converged"]
    assert abs(st["q0.5"]) < 0.1
    h = st["histogram"]
    assert int(h["counts"].sum() + h["underflow"] + h["overflow"]) == st["n"]


def test_error_paths():
    x = Distribution("norm")
    with pytest.raises(ValueError, match="replicates must be"):
        streaming.estimate(x, 1024, target_sem=0.1, replicates=1, random_state=0)
    with pytest.raises(ValueError, match="must be > 0"):
        streaming.estimate(x, 1024, target_sem=0.0, random_state=0)
    with pytest.raises(ValueError, match="must be > 0"):
        streaming.estimate(x, 1024, target_rel_sem=-1.0, random_state=0)
    with pytest.raises(ValueError, match="max_size"):
        streaming.estimate(x, 1024, target_sem=0.1, max_size=512, random_state=0)
    # QMC sequential stopping needs replicates (the between-replicate sem).
    with pytest.raises(ValueError, match="QMC error bar"):
        streaming.estimate(x, 1024, target_sem=0.1, method="sobol", random_state=0)


def test_default_max_size_is_64_pilots():
    x = Distribution("norm")
    st = streaming.estimate(x, 256, block_size=256, random_state=0, target_sem=1e-9)
    assert st["converged"] is False and st["n"] == 64 * 256
    # max_size alone (no target) leaves a fixed-size run, as in the JAX package.
    assert streaming.estimate(x, 256, block_size=256, random_state=0, max_size=10_000)["n"] == 256


# --- TestSequentialReplicated (the PRNG cases) ------------------------------------------


def test_prng_sequential_replicated_also_works():
    x = Distribution("norm", loc=5.0, scale=2.0)
    st = streaming.estimate(
        x, 2048, block_size=1024, random_state=2, target_sem=0.02, replicates=2
    )
    assert st["converged"] and st["sem"] <= 0.02
    assert st["replicates"] == 2


def test_stopping_sem_valid_vs_independent_truth():
    """The between-replicate sem matches the spread of independent runs of
    the same recipe within a factor of 3 (the JAX test's, on PRNG draws)."""
    y = Exp(Distribution("norm", loc=0.0, scale=1.0))
    st = streaming.estimate(
        y, 8192, block_size=2048, random_state=1, target_sem=0.01, replicates=4, max_size=1 << 17
    )
    singles = [
        streaming.estimate(y, st["n"] // 4, block_size=2048, random_state=100 + i)["mean"]
        for i in range(16)
    ]
    truth_sd = float(np.std(singles, ddof=1))
    assert 0.3 * truth_sd < st["sem"] * 2.0 < 3.0 * truth_sd
    assert abs(st["mean"] - np.exp(0.5)) < 6 * st["sem"] + 1e-5


# --- TestStreamCheckpoint ---------------------------------------------------------------


def _run(x, path, **kw):
    return streaming.estimate(
        x, 10_000, block_size=1024, random_state=0, checkpoint=str(path), checkpoint_every=2048,
        **kw
    )


def _dying_after(monkeypatch, segments):
    """Make ``_estimate_carry`` raise after ``segments`` calls."""
    real = streaming._estimate_carry
    calls = {"n": 0}

    def dying(*a, **k):
        if calls["n"] >= segments:
            raise RuntimeError("simulated crash")
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(streaming, "_estimate_carry", dying)
    return real


def test_completed_run_removes_file_and_matches_plain_segments(tmp_path):
    x = Distribution("norm", loc=1.0, scale=2.0)
    p = tmp_path / "run.ckpt.npz"
    st = _run(x, p)
    assert not os.path.exists(p)
    assert abs(st["mean"] - 1.0) < 0.1
    st2 = _run(x, p)  # deterministic: bitwise again
    assert st["mean"] == st2["mean"] and st["var"] == st2["var"]
    # The segments fold the blocks of the uninterrupted stream: the same
    # draws, so the same count, extremes and histogram as one plain run.
    plain = streaming.estimate(x, 10_000, block_size=1024, random_state=0,
                               histogram=(-5.0, 7.0, 24))
    ck = _run(x, p, histogram=(-5.0, 7.0, 24))
    assert (ck["n"], ck["min"], ck["max"]) == (plain["n"], plain["min"], plain["max"])
    np.testing.assert_array_equal(ck["histogram"]["counts"], plain["histogram"]["counts"])
    assert ck["mean"] == pytest.approx(plain["mean"], rel=1e-12)


def test_killed_run_resumes_bitwise_identically(tmp_path, monkeypatch):
    y = Exp(Distribution("norm", loc=1.0, scale=2.0))
    p = tmp_path / "run.ckpt.npz"
    full = _run(y, p, quantiles=(0.9,), moments=True, histogram=(0.0, 50.0, 10))
    real = _dying_after(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _run(y, p, quantiles=(0.9,), moments=True, histogram=(0.0, 50.0, 10))
    monkeypatch.setattr(streaming, "_estimate_carry", real)
    assert p.exists()  # the two segments' carries survived the crash
    resumed = _run(y, p, quantiles=(0.9,), moments=True, histogram=(0.0, 50.0, 10))
    for k in ("mean", "var", "std", "sem", "min", "max", "q0.9", "skew", "kurt"):
        assert resumed[k] == full[k], k
    np.testing.assert_array_equal(resumed["histogram"]["counts"], full["histogram"]["counts"])
    assert not p.exists()


def test_mismatched_run_refused(tmp_path, monkeypatch):
    x = Distribution("norm", loc=1.0, scale=2.0)
    p = tmp_path / "run.ckpt.npz"
    real = _dying_after(monkeypatch, 1)
    with pytest.raises(RuntimeError):
        _run(x, p)
    monkeypatch.setattr(streaming, "_estimate_carry", real)
    assert p.exists()
    with pytest.raises(ValueError, match="different run"):  # another seed
        streaming.estimate(x, 10_000, block_size=1024, random_state=1, checkpoint=str(p),
                           checkpoint_every=2048)
    with pytest.raises(ValueError, match="different run"):  # another size
        streaming.estimate(x, 20_000, block_size=1024, random_state=0, checkpoint=str(p),
                           checkpoint_every=2048)
    with pytest.raises(ValueError, match="different run"):  # another graph
        _run(x * 2.0, p)


def test_checkpoint_composition_errors(tmp_path):
    x = Distribution("norm")
    with pytest.raises(ValueError, match="checkpoint"):
        streaming.estimate(x, 1024, checkpoint=str(tmp_path / "c.npz"), replicates=2,
                           random_state=0)
    with pytest.raises(ValueError, match="checkpoint"):
        streaming.estimate(x, 1024, checkpoint=str(tmp_path / "c.npz"), target_sem=0.1,
                           random_state=0)
    with pytest.raises(ValueError, match="checkpoint_every"):
        streaming.estimate(x, 1024, checkpoint_every=512, random_state=0)


def test_checkpoint_needs_an_explicit_random_state(tmp_path):
    """R3: fresh entropy never matches the saved fingerprint, so a run
    seeded from it could never resume; the port refuses it."""
    with pytest.raises(ValueError, match="random_state"):
        streaming.estimate(Distribution("norm"), 1024, checkpoint=str(tmp_path / "c.npz"))
    assert not (tmp_path / "c.npz").exists()


def test_non_finite_run_keeps_its_checkpoint(tmp_path):
    """The file goes only after the result is final: a run that fails the
    finite check keeps its carries (R4's order, in estimate)."""
    p = tmp_path / "bad.npz"
    with pytest.raises(ValueError, match="non-finite"):
        _run(Log(Distribution("norm", loc=-100.0, scale=1.0)), p)
    assert p.exists()


def test_segment_windows_are_the_blocks_of_one_stream():
    """Two windows of a stream fold the blocks one uninterrupted carry
    folds: the same count, extremes and histogram, the mean to rounding."""
    x = Distribution("uniform")
    opts = dict(histogram=(0.0, 1.0, 8))
    whole = streaming._estimate_carry(x, 5000, 1024, 11, "auto", **opts)
    parts = [streaming._estimate_carry(x, 5000, 1024, 11, "auto", **opts, block_lo=0,
                                       n_blocks=3, last_count=1024),
             streaming._estimate_carry(x, 5000, 1024, 11, "auto", **opts, block_lo=3,
                                       n_blocks=2, last_count=5000 - 4 * 1024)]
    merged, _ = streaming._merge_carries(parts)
    assert float(merged[0]) == float(whole[0]) == 5000
    assert float(merged[3]) == float(whole[3]) and float(merged[4]) == float(whole[4])
    torch.testing.assert_close(merged[10], whole[10].cpu(), rtol=0, atol=0)
    assert float(merged[1]) == pytest.approx(float(whole[1]), rel=1e-12)


# --- TestCheckpoint and TestCheckpointFingerprint ---------------------------------------


def test_roundtrip_in_process(tmp_path):
    a = Distribution("norm")
    expr = Exp(a) + 1
    expr.sample(100, random_state=0)
    path = checkpoint.save(expr, tmp_path / "state.npz")
    original = expr.samples_.clone()
    expr.sample(100, random_state=1)  # overwrite with another state
    assert not torch.allclose(expr.samples_, original)
    checkpoint.load(expr, path)
    torch.testing.assert_close(expr.samples_, original)
    assert hasattr(a, "samples_")


def test_restore_into_fresh_graph(tmp_path):
    def build():
        a = Distribution("norm", loc=1, scale=2)
        return Exp(a) * 3

    g1 = build()
    g1.sample(50, random_state=7)
    path = checkpoint.save(g1, tmp_path / "s.npz")
    g2 = build()  # other ids, the same structure
    checkpoint.load(g2, path)
    torch.testing.assert_close(g2.samples_, g1.samples_)


def test_gc_state_roundtrip(tmp_path):
    expr = Distribution("norm") + 1
    expr.sample(10, random_state=0, gc_strategy=[])
    path = checkpoint.save(expr, tmp_path / "gc.npz")
    g2 = Distribution("norm") + 1
    checkpoint.load(g2, path)
    assert hasattr(g2, "samples_")
    assert not hasattr(list(g2.get_parents())[0], "samples_")


def test_mismatched_graph_rejected(tmp_path):
    g1 = Distribution("norm") + Distribution("expon")
    g1.sample(10, random_state=0)
    path = checkpoint.save(g1, tmp_path / "fp.npz")
    with pytest.raises(ValueError, match="fingerprint"):
        checkpoint.load(Distribution("norm") * Distribution("expon"), path)


def test_fingerprint_stable_across_rebuilds():
    def build():
        return Distribution("norm", loc=2) ** Distribution("uniform")

    assert checkpoint.graph_fingerprint(build()) == checkpoint.graph_fingerprint(build())
    assert checkpoint.graph_fingerprint(build() + 1) != checkpoint.graph_fingerprint(build() + 1.0)
    plan = tcompile.get_plan(build())
    assert len(plan.topo) == 3
