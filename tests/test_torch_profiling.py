"""The port's profiling utilities (``probabilit_tpu_torch/utils/profiling.py``)
on the CPU.

``PhaseTimer`` accumulates named phases and reports them as the JAX
package's does; ``compiled_stats`` returns the JAX package's four keys,
its flops equal to a hand count (a matrix product 2mnk, one flop per
element of any other op, nothing for a view) and its bytes to each op's
inputs read plus outputs written, with ``peak_bytes`` None on the CPU;
``trace`` writes a Chrome trace under its ``logdir``; and
``PROBABILIT_TPU_PROFILE=1`` makes ``sample`` print the
``[probabilit-tpu profile]`` header and its build+compile, execute and
host phases to stderr (``test_streaming_checkpoint.py``'s
``TestProfilingIntegration``), while with it unset nothing is printed and
no timer is made.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu.utils import profiling as jax_profiling
import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.parallel import make_mesh, use_mesh
from probabilit_tpu_torch.utils import profiling
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


def test_profiling_enabled_reads_the_variable(monkeypatch):
    monkeypatch.delenv("PROBABILIT_TPU_PROFILE", raising=False)
    assert not profiling.profiling_enabled()
    monkeypatch.setenv("PROBABILIT_TPU_PROFILE", "1")
    assert profiling.profiling_enabled()
    monkeypatch.setenv("PROBABILIT_TPU_PROFILE", "0")
    assert not profiling.profiling_enabled()


def test_phase_timer_accumulates_and_reports():
    timer = profiling.PhaseTimer()
    with timer.phase("build+compile"):
        pass
    for _ in range(2):
        with timer.phase("execute", torch.device("cpu")):  # no sync on the CPU
            sum(range(1000))
    assert list(timer.phases) == ["build+compile", "execute"]
    assert all(v >= 0.0 for v in timer.phases.values())
    lines = timer.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("build+compile  ") and lines[1].endswith(" ms")
    assert lines[1].startswith("execute        ")
    # The JAX package's report has the same layout for the same phases.
    ref = jax_profiling.PhaseTimer()
    ref.phases = dict(timer.phases)
    assert ref.report() == timer.report()


def test_phase_timer_records_a_phase_that_raises():
    timer = profiling.PhaseTimer()
    with pytest.raises(RuntimeError):
        with timer.phase("execute"):
            raise RuntimeError("boom")
    assert "execute" in timer.phases


def test_compiled_stats_counts_by_hand():
    m, k, n = 8, 5, 3
    x, w = torch.randn(m, k), torch.randn(k, n)

    def fn(x, w):
        return torch.exp(x @ w) + 1.0  # mm, exp, add

    stats = profiling.compiled_stats(fn, x, w)
    assert set(stats) == {"flops", "bytes_accessed", "peak_bytes", "output_bytes"}
    assert stats["flops"] == 2 * m * n * k + m * n + m * n
    # mm reads x and w and writes (m, n); exp and add read and write (m, n).
    assert stats["bytes_accessed"] == 4 * ((m * k + k * n + m * n) + 2 * m * n + 2 * m * n)
    assert stats["output_bytes"] == 4 * m * n
    assert stats["peak_bytes"] is None  # the CPU keeps no peak counter


def test_compiled_stats_counts_views_as_nothing():
    x = torch.randn(8, 5)
    stats = profiling.compiled_stats(lambda x: (x.T[:3] * 2.0).sum(), x)
    assert stats["flops"] == 3 * 8 + 1
    assert stats["output_bytes"] == 4


def test_compiled_stats_has_the_jax_keys():
    x = np.ones((4, 4), np.float32)
    ref = jax_profiling.compiled_stats(jax.jit(lambda a: jnp.exp(a) @ a), x)
    got = profiling.compiled_stats(lambda a: torch.exp(a) @ a, torch.from_numpy(x))
    assert set(got) == set(ref)
    assert got["flops"] == 2 * 4 * 4 * 4 + 16
    assert got["output_bytes"] == ref["output_bytes"] == 64


def test_compiled_stats_of_the_plain_body():
    from probabilit_tpu_torch.engine import compile as tcompile

    sink = benchmarks.mixed_dag_20()
    plan = tcompile.get_plan(sink)
    body = tcompile.build_body(plan, {sink._id})
    q = torch.rand(1024, plan.d)
    stats = profiling.compiled_stats(body, q)
    assert stats["output_bytes"] == 4 * 1024
    assert stats["flops"] >= 1024 * (plan.d + 12)  # a ppf per column, a transform per node
    assert stats["bytes_accessed"] > stats["output_bytes"]


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(logdir=str(logdir)) as where:
        assert where == str(logdir)
        pt.Distribution("norm").sample(256, random_state=0)
    path = os.path.join(str(logdir), "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_sample_emits_phase_report(capfd, monkeypatch):
    monkeypatch.setenv("PROBABILIT_TPU_PROFILE", "1")
    pt.Distribution("norm").sample(64, random_state=0)
    err = capfd.readouterr().err
    assert "[probabilit-tpu profile]" in err
    for phase in ("build+compile", "execute", "host"):
        assert phase in err


def test_sample_from_quantiles_and_mesh_emit_phase_report(capfd, monkeypatch):
    monkeypatch.setenv("PROBABILIT_TPU_PROFILE", "1")
    node = pt.Distribution("norm")
    node.sample_from_quantiles(np.full((8, 1), 0.5))
    with use_mesh(make_mesh([torch.device("cpu")] * 2)):
        node.sample(64, random_state=0, method="sobol")
    err = capfd.readouterr().err
    assert err.count("[probabilit-tpu profile]") == 2
    assert err.count("execute") == 2


def test_unset_profile_prints_nothing_and_makes_no_timer(capfd, monkeypatch):
    monkeypatch.delenv("PROBABILIT_TPU_PROFILE", raising=False)

    def refuse():
        raise AssertionError("a PhaseTimer was made with profiling off")

    monkeypatch.setattr(profiling, "PhaseTimer", refuse)
    pt.Distribution("norm").sample(64, random_state=0)
    assert capfd.readouterr().err == ""
