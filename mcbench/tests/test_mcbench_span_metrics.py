"""The readers of the port's spans (``mcbench/spans.py``) on a synthetic
timeline whose host operations hold nested ``probabilit.*`` spans and
kernel launches, each reading against a count made by hand; and on the
CPU profiler's trace of the cells' calls cut to a small size, on the
kernels' plain twins."""

from types import SimpleNamespace

import pytest
import torch

from mcbench import spec, timeline
from mcbench.timeline import Timeline

MS = 1_000_000  # ns
US = 1_000
CALLS = [(0, 10 * MS), (12 * MS, 22 * MS)]
READERS = ("driver_self_ms_per_call", "host_waits_per_call", "fold_host_ms_per_block",
           "fold_launches_per_block", "solve_host_ms_per_block")


def streamed_call(t0, correlated):
    """A streamed call of two blocks: entry 9 ms; per block K2 and a solve
    (correlated only), K1 and a fold; the carry's read at the end."""
    ops = [("probabilit.estimate", t0 + 500 * US, t0 + 9500 * US)]
    for b, (k1, fold, fold_ms) in enumerate([(t0 + 1 * MS, t0 + 2 * MS, 1.0),
                                             (t0 + 3500 * US, t0 + 4500 * US, 1.5)]):
        if correlated:
            ops += [("probabilit.k2", k1 - 400 * US, k1 - 300 * US),
                    ("probabilit.solve", k1 - 250 * US, k1 - 50 * US),
                    ("cudaLaunchKernel", k1 - 200 * US, k1 - 190 * US)]
        ops += [("probabilit.k1", k1, k1 + 500 * US),
                ("cudaLaunchKernel", k1 + 200 * US, k1 + 210 * US),  # K1's own: not the fold's
                ("probabilit.fold", fold, fold + int(fold_ms * MS)),
                ("aten::add", fold + 50 * US, fold + 400 * US),
                ("cudaLaunchKernel", fold + 100 * US, fold + 110 * US),
                ("cudaLaunchKernelExC", fold + 200 * US, fold + 210 * US)]
        if b == 1:
            ops.append(("cuLaunchKernel", fold + 1 * MS, fold + 1 * MS + 10 * US))
    ops.append(("probabilit.wait", t0 + 7 * MS, t0 + 9 * MS))
    ops.append(("cudaMemcpyAsync", t0 + 7 * MS, t0 + 9 * MS))
    return ops


def oneshot_call(t0):
    """A correlated one-shot call: entry 8 ms; K2, a host solve that waits
    inside it, K1, and the wait for the non-finite flag."""
    return [
        ("probabilit.sample", t0 + 1 * MS, t0 + 9 * MS),
        ("probabilit.k2", t0 + 2 * MS, t0 + 2500 * US),
        ("probabilit.solve", t0 + 3 * MS, t0 + 5 * MS),
        ("probabilit.wait", t0 + 3 * MS, t0 + 4 * MS),
        ("cudaMemcpyAsync", t0 + 3 * MS, t0 + 4 * MS),
        ("probabilit.k1", t0 + 5500 * US, t0 + 6 * MS),
        ("probabilit.wait", t0 + 7 * MS, t0 + 8 * MS),
    ]


def run_of(name, host_ops, blocks=2):
    cell = spec.Cell(name)
    cell.traffic = dict(cell.traffic, size=blocks * 100, options=dict(cell.traffic["options"]))
    if cell.streamed:
        cell.traffic["options"]["block_size"] = 100
    device = [("void graph_megakernel<4>(Consts, float const*)", 1 * MS, 2 * MS)]
    return SimpleNamespace(cell=cell, timeline=Timeline(device, host_ops, CALLS))


def read(name, run):
    return spec.reader(name)(run)


def test_a_dag_stream_reads_its_hand_counts():
    run = run_of("dag20.stream.moments", streamed_call(0, False) + streamed_call(12 * MS, False))
    # Entry 9 ms less K1 0.5 + 0.5, the folds 1 + 1.5 and the wait 2.
    assert read("driver_self_ms_per_call", run) == pytest.approx(3.5)
    assert read("host_waits_per_call", run) == 1.0
    assert read("fold_host_ms_per_block", run) == pytest.approx(1.25)
    # Two launches in the first fold, three in the second; K1's are not counted.
    assert read("fold_launches_per_block", run) == pytest.approx(2.5)
    assert read("solve_host_ms_per_block", run) is None


def test_a_correlated_stream_reads_its_solve():
    run = run_of("corr50.stream.moments", streamed_call(0, True) + streamed_call(12 * MS, True))
    assert read("solve_host_ms_per_block", run) == pytest.approx(0.2)
    assert read("fold_launches_per_block", run) == pytest.approx(2.5)
    # The K2 and solve spans of each block cover 0.3 ms more of the entry.
    assert read("driver_self_ms_per_call", run) == pytest.approx(3.5 - 2 * 0.3)


def test_a_one_shot_reads_two_waits_and_no_fold():
    run = run_of("corr50.oneshot", oneshot_call(0) + oneshot_call(12 * MS), blocks=1)
    assert read("host_waits_per_call", run) == 2.0
    # Entry 8 ms less K2 0.5, the solve 2 (its wait inside it), K1 0.5, the wait 1.
    assert read("driver_self_ms_per_call", run) == pytest.approx(4.0)
    assert read("solve_host_ms_per_block", run) == pytest.approx(2.0)
    assert read("fold_host_ms_per_block", run) is None
    assert read("fold_launches_per_block", run) is None


def test_a_span_outside_every_call_is_not_read():
    stray = [("probabilit.wait", 10500 * US, 11 * MS), ("probabilit.fold", 10500 * US, 11 * MS)]
    run = run_of("dag20.stream.moments",
                 streamed_call(0, False) + stray + streamed_call(12 * MS, False))
    assert read("host_waits_per_call", run) == 1.0
    assert read("fold_host_ms_per_block", run) == pytest.approx(1.25)


@pytest.mark.parametrize("cell", ["dag20.stream.moments", "dag20.stream.tails",
                                  "corr50.stream.moments", "corr50.oneshot"])
def test_a_program_without_spans_reads_nothing(cell):
    """A version of the port that opens no span: every reader gives None."""
    host = [("aten::add", 1 * MS, 2 * MS), ("cudaLaunchKernel", 1 * MS, 1 * MS + 10 * US),
            ("cudaStreamSynchronize", 3 * MS, 9 * MS)]
    run = run_of(cell, host, blocks=2 if spec.Cell(cell).streamed else 1)
    assert {name: read(name, run) for name in READERS} == dict.fromkeys(READERS)


def test_the_new_entries_list_the_cells_their_readers_read():
    entries = {m["name"]: m for m in spec.load_json(spec.ROOT / "BENCHMARK.json")["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] == "program_span"
    assert entries["solve_host_ms_per_block"]["workloads"] == ["corr50.stream.moments"]
    assert entries["host_waits_per_call"]["workloads"] == [
        "dag20.stream.moments", "dag20.stream.tails", "corr50.oneshot"]


@pytest.mark.usefixtures("twins")
@pytest.mark.parametrize("cell, waits", [("dag20.stream.moments", 1), ("corr50.stream.moments", 1),
                                         ("corr50.oneshot", 2)])
def test_the_ports_own_spans_read_on_the_cpu(cell, waits):
    from conftest import SEED, small_cell

    from probabilit_tpu_torch import config

    config.set_device("cpu")
    cell = small_cell(cell)
    call = spec.caller(spec.build_graph(cell.config), cell.traffic)
    call(spec.call_seed(SEED, 1, 0))  # the plan and the tape
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(2):
            with torch.profiler.record_function(timeline.CALL_SPAN):
                call(spec.call_seed(SEED, 0, i))
    run = SimpleNamespace(cell=cell, timeline=timeline.from_profiler(prof))
    assert read("host_waits_per_call", run) == waits
    assert read("driver_self_ms_per_call", run) > 0
    if cell.streamed:
        assert cell.blocks_per_call == 4
        assert read("fold_host_ms_per_block", run) > 0
        assert read("fold_launches_per_block", run) == 0  # no card: no launch
    if cell.correlated:
        assert read("solve_host_ms_per_block", run) > 0
