"""What a cell is made of, read from files by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration lives in its ``file``, the mix in ``traffic/<name>.json``,
the limits of its output check in ``limits/<cell>.json``, and each
per-layer metric's reader in ``metrics/<name>.py``.  The mix names the
entry it calls on the configuration's sink (any method of a node, such as
``estimate`` or ``sample``), the kind of answer that call returns, whose
reference and comparison live in ``answers/<kind>.py``, and the launches
of the port's kernel counters that one call makes.  A new cell, mix,
configuration, answer or metric is a new file and a new entry, never an
edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name, root=ROOT):
        self.bench = load_json(Path(root) / "BENCHMARK.json")
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(by_name)})")
        self.workload = by_name[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(Path(root) / configs[self.workload["config"]]["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.chips = self.workload["chips"]

    def metrics(self, kind):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]

    @property
    def streamed(self):
        """Whether a call's answer is the statistics folded over its blocks."""
        return self.traffic["answer"] == "statistics"

    @property
    def correlated(self):
        return bool(self.config.get("correlation"))

    @property
    def size(self):
        return int(self.traffic["size"])

    @property
    def rows_per_launch(self):
        """Samples of one K1 (and K2) launch: a block, or the whole call."""
        return int(self.traffic["options"].get("block_size", self.size))

    @property
    def blocks_per_call(self):
        """The blocks of one call: one, where the mix gives no block size."""
        return -(-self.size // self.rows_per_launch)

    def launches(self):
        """Per launch counter of the port (``module.NAME`` under
        ``probabilit_tpu_torch``), the launches one call makes: the mix
        gives each as a number, ``blocks``, or ``blocks_if_correlated``."""
        counts = {"blocks": self.blocks_per_call,
                  "blocks_if_correlated": self.blocks_per_call if self.correlated else 0}
        return {name: counts[v] if isinstance(v, str) else int(v)
                for name, v in self.traffic["launches"].items()}

    def answer(self):
        """The module of ``answers/<kind>.py`` for the mix's kind of answer."""
        return _load("answers", self.traffic["answer"])


def _load(folder, name):
    """The module of ``<folder>/<name>.py``, loaded once."""
    key = f"mcbench_{folder}_" + name.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, HERE / folder / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def reader(metric_name):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    return _load("metrics", metric_name).read


def build_graph(config, nodes=None):
    """The configuration's graph from the port's public node classes;
    returns the sink (and fills ``nodes``, if given, by name)."""
    from probabilit_tpu_torch.models import graph
    from probabilit_tpu_torch.models.distributions import Distribution

    nodes = {} if nodes is None else nodes
    for node in config["nodes"]:
        if "family" in node:
            nodes[node["name"]] = Distribution(node["family"], **node["params"])
        else:
            args = [nodes[a] if isinstance(a, str) else a for a in node["inputs"]]
            nodes[node["name"]] = getattr(graph, node["op"])(*args)
    sink = nodes[config["sink"]]
    corr = config.get("correlation")
    if corr:
        sink.correlate(*(nodes[v] for v in corr["variables"]),
                       corr_mat=np.asarray(corr["matrix"], dtype=np.float64))
    return sink


def call_seed(seed, *path):
    """A 63-bit ``random_state`` for the call at ``path`` under the run's seed."""
    words = np.random.SeedSequence(int(seed) % 2**128, spawn_key=path).generate_state(2, np.uint32)
    return (int(words[0]) | int(words[1]) << 32) >> 1


def caller(sink, traffic):
    """``call(random_state)``: one call of the traffic mix, the entry it
    names on the sink with the call's size and options (JSON lists as
    tuples), complete when it returns: the device is waited for where the
    answer holds a tensor on it."""
    options = {k: tuple(v) if isinstance(v, list) else v for k, v in traffic["options"].items()}
    size = int(traffic["size"])
    entry = getattr(sink, traffic["entry"])

    def call(s):
        out = entry(size, random_state=s, **options)
        _wait(out)
        return out

    return call


def _wait(out):
    """Wait for every card that holds a tensor of ``out`` (nested in
    dicts, lists and tuples)."""
    import torch

    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _wait(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _wait(v)
