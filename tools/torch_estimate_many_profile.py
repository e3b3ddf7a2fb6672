"""Where the time of ``estimate_many`` goes, on one card.

    python3 tools/torch_estimate_many_profile.py [--n 268435456]

Profiles one ``estimate_many`` of ``mixed_dag_20``'s sink and the seven
non-constant nodes nearest it (``chip_smoke.py`` phase 19's nodes), in
2^24-blocks, with ``torch.profiler``: with every option phase 19 uses
(quantiles, CVaR, a histogram, moments, covariance) and with none, and
the block program alone (the plain executor's draws and graph, no fold).
Each prints its host-clock wall time (median of 3 after a warm-up), its
device time grouped by what the kernels do (``torch.sort``'s kernels, the
covariance's matrix product, reductions, histograms, the rest
elementwise), the card's idle share and its peak memory.  Prints one JSON
object per line, the card's ``nvidia-smi`` name and power limit first.
Needs a CUDA card; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GROUPS = (  # (substring of a kernel's name, group), first match wins
    ("sort", "sort"), ("radix", "sort"), ("gemm", "matmul"), ("gemv", "matmul"),
    ("histogram", "histogram"), ("histc", "histogram"), ("reduce", "reduction"),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1 << 28)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; torch.cuda.is_available() is False.")
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import streaming
    from probabilit_tpu_torch.models.benchmarks import mixed_dag_20
    from probabilit_tpu_torch.models.graph import Constant, NoOp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    config.set_device("cuda")
    block = 1 << 24
    plan = _compile.get_plan(mixed_dag_20())
    nodes = [node for node in plan.topo if not isinstance(node, Constant)][-8:]
    emit({"device": smi, "torch": torch.__version__, "n": args.n, "block": block,
          "nodes": len(nodes)})
    full = dict(quantiles=(0.05, 0.5, 0.95), cvar=(0.95, 0.99), histogram=(-2e4, 1.5e5, 100),
                moments=True, covariance=True)
    _, run = streaming._block_program(NoOp(*nodes), block, extra=tuple(nodes))

    def draws_only():
        for b in range(-(-args.n // block)):
            run(b, 0)

    calls = {
        "all_options": lambda: streaming.estimate_many(nodes, args.n, block_size=block,
                                                       random_state=0, **full),
        "no_options": lambda: streaming.estimate_many(nodes, args.n, block_size=block,
                                                      random_state=0),
        "block_program_alone": draws_only,
    }
    for name, call in calls.items():
        def timed():
            torch.cuda.synchronize()
            start = time.perf_counter()
            call()
            torch.cuda.synchronize()
            return (time.perf_counter() - start) * 1e3

        timed()
        wall_ms = statistics.median(timed() for _ in range(3))
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            profiled_ms = timed()
        device, top = {}, {}
        for event in prof.key_averages():
            us = getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
            if us and event.device_type == torch.autograd.DeviceType.CUDA:
                key = event.key.lower()
                group = next((g for s, g in GROUPS if s in key), "elementwise")
                device[group] = device.get(group, 0.0) + us / 1e3
                top[event.key[:80]] = us / 1e3
        busy = sum(device.values())
        emit({"call": name, "card": smi, "wall_ms": wall_ms, "profiled_ms": profiled_ms,
              "device_ms_by_group": device, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / profiled_ms,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:10])})


if __name__ == "__main__":
    main()
