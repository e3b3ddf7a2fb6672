"""The per-layer metric readers on a recorded, synthetic timeline."""

from types import SimpleNamespace

import pytest

from mcbench import spec, yardstick
from mcbench.timeline import Timeline

MS = 1_000_000  # ns

# Two calls of 10 ms each, 2 ms apart; in each, K1 for 2 ms, K2 for 1 ms,
# a sort for 1 ms and a fold kernel for 0.5 ms, some overlapping.
CALLS = [(0, 10 * MS), (12 * MS, 22 * MS)]


def ops(t0):
    return [
        ("void graph_megakernel<4>(Consts, float const*)", t0 + 1 * MS, t0 + 3 * MS),
        ("void corr_stats<10>(Columns, PhiloxKeys)", t0 + 3 * MS, t0 + 4 * MS),
        ("void at::native::radixSortKVInPlace<float>", t0 + 4 * MS, t0 + 5 * MS),
        ("void at::native::reduce_kernel<512, 1>", t0 + 4500_000, t0 + 5500_000),
    ]


HOST = [("aten::sort", 4 * MS, 6 * MS), ("cudaStreamSynchronize", 6 * MS, 9 * MS)]


def run_of(name, blocks=2):
    cell = spec.Cell(name)
    cell.traffic = dict(cell.traffic, size=blocks * 100, options=dict(cell.traffic["options"]))
    if cell.streamed:
        cell.traffic["options"]["block_size"] = 100
    line = Timeline(ops(0) + ops(12 * MS), HOST, CALLS)
    return SimpleNamespace(cell=cell, timeline=line)


def test_timeline_busy_and_groups():
    line = run_of("corr50.stream.moments").timeline
    assert line.window_ns == 22 * MS
    assert line.busy_ns() == 2 * 4500_000
    assert line.busy_ns(0, 10 * MS) == 4500_000
    assert line.group_ns("k1") == 4 * MS
    assert line.group_ns("sort") == 2 * MS
    assert line.group_ns("other") == 2 * MS
    assert line.gaps()[0] == (0, 1 * MS)
    assert line.host_during(5 * MS, 10 * MS) == {
        "aten::sort": 1 * MS, "cudaStreamSynchronize": 3 * MS, "python": 1 * MS}
    down = line.breakdown()
    assert down["device_ops"][0] == ["void graph_megakernel<4>(Consts, float const*)", 0.004]
    idle = dict(down["idle_gaps"])
    assert idle["cudaStreamSynchronize"] == 0.003 and idle["aten::sort"] == 0.0005
    assert sum(idle.values()) == pytest.approx((22 * MS - line.busy_ns()) / 1e9)


def test_readers_give_known_numbers():
    run = run_of("corr50.stream.moments")
    read = {name: spec.reader(name)(run) for name in (
        "exposed_host_ms_per_call", "device_idle_pct", "fold_device_ms_per_block",
        "sort_device_ms_per_block", "k1_roofline_pct", "k2_roofline_pct")}
    assert read["exposed_host_ms_per_call"] == pytest.approx(5.5)
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 9 / 22))
    assert read["fold_device_ms_per_block"] == pytest.approx(0.5)  # 2 calls x 2 blocks
    assert read["sort_device_ms_per_block"] == pytest.approx(0.5)
    k1, _ = yardstick.k1_bound(run.cell.config, 100)
    k2, _ = yardstick.k2_bound(run.cell.config, 100)
    assert read["k1_roofline_pct"] == pytest.approx(100 * k1 / 2e-3)
    assert read["k2_roofline_pct"] == pytest.approx(100 * k2 / 1e-3)


def test_host_paced_readers_read_as_their_base():
    run = run_of("corr50.stream.moments")
    for base in ("exposed_host_ms_per_call", "k1_roofline_pct", "k2_roofline_pct",
                 "device_idle_pct"):
        assert spec.reader(base + ".host_paced")(run) == spec.reader(base)(run)


def test_readers_that_find_nothing_return_nothing():
    run = run_of("dag20.stream.moments")
    assert spec.reader("k2_roofline_pct")(run) is None
    oneshot = run_of("corr50.oneshot", blocks=1)
    assert spec.reader("fold_device_ms_per_block")(oneshot) is None
    assert spec.reader("sort_device_ms_per_block")(oneshot) is None
    plain = SimpleNamespace(cell=run.cell, timeline=Timeline(
        [("void at::native::reduce_kernel<512, 1>", 0, MS)], [], CALLS))
    assert spec.reader("k1_roofline_pct")(plain) is None
    assert spec.reader("sort_device_ms_per_block")(plain) is None
