"""The port's ``probabilit.*`` spans (``utils/profiling.span``).

With no ``torch.profiler`` session a span is one shared no-op that enters
no record function.  Under a session each layer boundary records its span
on the host, nested in the call's entry span: ``probabilit.estimate`` and
``probabilit.sample``; ``probabilit.k1`` and ``probabilit.k2`` around the
kernels' wrappers (their plain twins on the CPU); ``probabilit.solve``
after the statistics; ``probabilit.fold`` once a streamed block;
``probabilit.wait`` where the host waits for the device;
``probabilit.plan`` and ``probabilit.build`` on a cache miss.  The one
test marked ``cuda`` traces a streamed estimate on the card and holds the
spans to the host's events: none is a device operation.  The file imports
no JAX, so on the machine with the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

import ctypes.util

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from probabilit_tpu_torch import _build, config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, streaming
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch CPU ops on one thread, as ``test_torch_graph``'s
    fixture of that name (imported there with JAX, which this file, run on
    the card too, does not import)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(previous)


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
def twins(monkeypatch):
    """The kernel path on the CPU: the wrappers run their plain twins, and
    the streamed driver takes the kernel path."""
    monkeypatch.setattr(cuda_exec, "environment_issue", lambda device=None: None)
    monkeypatch.setattr(streaming, "_resolve_executor", lambda *args: "cuda")


def _graph():
    return Distribution("lognorm", s=0.5) + Distribution("norm", loc=1.0)


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    """The ``probabilit.*`` host spans that ``fn()`` records, as (name,
    start_ns, end_ns) in order of start."""
    with profile(activities=list(activities)) as prof:
        fn()
    return _spans(prof)


def _spans(prof):
    cpu = torch.autograd.DeviceType.CPU
    return sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()
         if e.device_type() == cpu and e.name().startswith("probabilit.")),
        key=lambda s: (s[1], -s[2]),
    )


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record function was entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("probabilit.a") is profiling.span("probabilit.b")
    sink = _graph()
    assert sink.sample(1000, random_state=1).shape == (1000,)
    assert sink.estimate(5000, block_size=2048, random_state=1)["n"] == 5000


def test_a_span_is_recorded_only_while_the_profiler_records():
    def nested():
        with profiling.span("probabilit.outer"):
            with profiling.span("probabilit.inner"):
                torch.ones(4).sum()

    spans = _traced(nested)
    assert [s[0] for s in spans] == ["probabilit.outer", "probabilit.inner"]
    assert _inside(spans[1], spans[0])
    nested()  # after the session: no error, nothing recorded


def test_estimate_records_a_fold_a_block_and_one_wait():
    sink = _graph()
    spans = _traced(lambda: sink.estimate(2**20, block_size=2**18, random_state=3))
    (entry,) = _named(spans, "probabilit.estimate")
    folds = _named(spans, "probabilit.fold")
    waits = _named(spans, "probabilit.wait")
    assert len(folds) == 4 and len(waits) == 1
    assert all(_inside(s, entry) for s in folds + waits)
    assert waits[0][1] >= folds[-1][2]  # the carry is read after the last fold


def test_run_on_a_cpu_tape_records_k1():
    plan = tcompile.get_plan(benchmarks.mixed_dag_20())
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, {plan.sink._id}))
    spans = _traced(lambda: cuda_exec.run(tape, cuda_exec.seed_words(5), 4096))
    assert [s[0] for s in spans] == ["probabilit.k1"]


@pytest.mark.parametrize("solve", ["host", "device"])
def test_recolor_transform_records_k2_then_solve(solve):
    plan = tcompile.get_plan(benchmarks.mixed_correlated_50())
    words = cuda_exec.seed_words(7)
    spans = _traced(lambda: cuda_exec.recolor_transform(plan, words, 4096, "cpu", solve=solve))
    outer = [s for s in spans if s[0] != "probabilit.wait"]
    assert [s[0] for s in outer] == ["probabilit.k2", "probabilit.solve"]
    k2, solve_span = outer
    assert k2[2] <= solve_span[1]
    waits = _named(spans, "probabilit.wait")
    # The host solve waits once, for the statistics; the device solve never.
    assert len(waits) == (solve == "host")
    assert all(_inside(w, solve_span) for w in waits)


def test_sample_records_its_entry_and_the_finite_check():
    sink = _graph()
    spans = _traced(lambda: sink.sample(1000, random_state=2))
    (entry,) = _named(spans, "probabilit.sample")
    (wait,) = _named(spans, "probabilit.wait")
    assert _inside(wait, entry)


@pytest.mark.usefixtures("twins")
def test_a_correlated_one_shot_on_the_kernel_path_waits_twice():
    sink = benchmarks.mixed_correlated_50()
    sink.sample(4096, random_state=1, executor="cuda", gc_strategy=[])  # plan and tape
    spans = _traced(lambda: sink.sample(4096, random_state=2, executor="cuda", gc_strategy=[]))
    (entry,) = _named(spans, "probabilit.sample")
    names = [s[0] for s in spans if s is not entry]
    assert names == ["probabilit.k2", "probabilit.solve", "probabilit.wait",
                     "probabilit.k1", "probabilit.wait"]
    assert all(_inside(s, entry) for s in spans)


@pytest.mark.usefixtures("twins")
def test_a_correlated_stream_on_the_kernel_path_records_each_layer_a_block():
    sink = benchmarks.mixed_correlated_50()
    block = 1 << 14
    spans = _traced(lambda: sink.estimate(3 * block, block_size=block, random_state=4))
    (entry,) = _named(spans, "probabilit.estimate")
    for name in ("probabilit.k2", "probabilit.solve", "probabilit.k1", "probabilit.fold"):
        assert len(_named(spans, name)) == 3, name
    assert len(_named(spans, "probabilit.wait")) == 1  # the device solve never waits
    assert all(_inside(s, entry) for s in spans)


def test_plan_is_recorded_on_a_cache_miss_only():
    sink = _graph()
    assert [s[0] for s in _traced(lambda: tcompile.get_plan(sink))] == ["probabilit.plan"]
    assert _traced(lambda: tcompile.get_plan(sink)) == []


def test_build_is_recorded_on_a_load_miss_only():
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    key = ("test_torch_spans", libc)
    try:
        load = lambda: _build._load(key, lambda: (libc, ""))  # noqa: E731
        assert [s[0] for s in _traced(load)] == ["probabilit.build"]
        assert _traced(load) == []
    finally:
        _build._LIBS.pop(key, None)


@pytest.mark.cuda
def test_spans_are_host_events_on_the_card():
    if not torch.cuda.is_available() or cuda_exec.environment_issue("cuda") is not None:
        pytest.skip("needs an sm_90 CUDA card")
    config.set_device("cuda")
    sink = benchmarks.mixed_correlated_50()
    block = 1 << 20
    sink.estimate(2 * block, block_size=block, random_state=1)  # the builds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sink.estimate(4 * block, block_size=block, random_state=2)
        torch.cuda.synchronize()
    spans = _spans(prof)
    for name in ("probabilit.k2", "probabilit.solve", "probabilit.k1", "probabilit.fold"):
        assert len(_named(spans, name)) == 4, name
    assert len(_named(spans, "probabilit.estimate")) == len(_named(spans, "probabilit.wait")) == 1
    cuda = torch.autograd.DeviceType.CUDA
    device_names = [
        e.name() for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda and not e.is_user_annotation()
    ]
    assert any("graph_megakernel" in n for n in device_names)
    assert not [n for n in device_names if n.startswith("probabilit.")]
