"""``BENCHMARK.json`` and a run's last line keep to the benchmark's contract."""

import json
import re
import subprocess
import sys

import pytest

from mcbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["mcbench"] and BENCH["command"] == ["python3", "mcbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_lines():
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[kind]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and c["reduced"] == []
        assert c["file"].startswith("mcbench/") and (spec.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert one_line(w["why"]) and w["chips"] == 1 and NAME.match(w["traffic"])
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (spec.HERE / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("path", sorted((spec.HERE / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_a_mix_names_its_entry_answer_and_launches(path):
    from probabilit_tpu_torch.models.graph import Node

    mix = json.loads(path.read_text())
    assert mix["name"] == path.stem and callable(getattr(Node, mix["entry"]))
    assert (spec.HERE / "answers" / f"{mix['answer']}.py").is_file()
    for counter, count in mix["launches"].items():
        module, _, attr = counter.rpartition(".")
        assert isinstance(getattr(__import__(f"probabilit_tpu_torch.{module}", fromlist=[attr]), attr), int)
        assert count in ("blocks", "blocks_if_correlated") or isinstance(count, int)


def test_metrics_are_reported_where_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(m["layer"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert all(cell in e2e[m["moves"]].get("workloads", cells) for cell in m["workloads"])
    for cell in cells:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.usefixtures("twins")
def test_last_line_keys():
    from conftest import run_small

    result, _, checks = run_small("dag20.stream.moments")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"samples_per_s", "call_p95_ms", "setup_s"}
    paced, _, _ = run_small("corr50.stream.moments")
    assert set(paced["metrics"]) == {"samples_per_s.host_paced", "setup_s"}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert len(checks) == len(result["checks"])
    json.dumps(result)


def test_no_jax_after_importing_every_module():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import mcbench, mcbench.calibrate, mcbench.compare, mcbench.harness, mcbench.reference\n"
        "import mcbench.spec, mcbench.timeline, mcbench.yardstick\n"
        "import mcbench.run as run\n"
        "import json\n"
        "from mcbench import spec, harness\n"
        "bench = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())\n"
        "[spec.reader(m['name']) for m in bench['per_layer']]\n"
        "spec.build_graph(spec.Cell('corr50.stream.moments').config)\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names():
    from mcbench import harness

    sys.modules.setdefault("probabilit_tpu_torch_lookalike", sys)
    try:
        assert "probabilit_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("probabilit_tpu_torch_lookalike", None)
