"""Where the time of the port's CUDA path goes, on one card.

    python3 tools/torch_kernel_breakdown.py [--n 100000000] [--streamed-n 268435456]

Times the graph megakernel on tapes cut down from the two main paths'
graphs, each alone, with CUDA events (median of 10 after one warm-up),
and profiles one ``sample(executor="cuda")`` call of each path with
``torch.profiler`` for its device time and idle share, then one streamed
``estimate(quantiles, cvar)`` of each graph (``--streamed-n`` draws in
2^24-blocks), its device time grouped by what the kernels do.  The cut-down
graphs keep the main paths' distributions and drop the rest:

* ``mixed_dag_20``: a store-only tape and the 8 draws summed (Philox:
  tapes written by hand, ``LOADK``/``STORE`` and ``DRAW``/``ADD``/
  ``STORE``), 8 normals summed, and the full graph;
* ``mixed_correlated_50``: the 10 draws summed (by hand); the 10 drivers
  with their own families, summed, uncorrelated (plus the ppfs); the
  same, correlated (plus ``SCORE``/``RECOLOR``/``NDTR``); and the full
  graph (plus the transform lattice).  The statistics kernel is
  timed beside them.

Prints one JSON object per line, the card's ``nvidia-smi`` name and
power limit first.  Needs a CUDA card; run from the repository root.
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, repeats=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=100_000_000)
    parser.add_argument("--streamed-n", type=int, default=1 << 28)
    args = parser.parse_args()
    n = args.n

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; torch.cuda.is_available() is False.")
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import cuda_exec
    from probabilit_tpu_torch.models import benchmarks
    from probabilit_tpu_torch.models.distributions import Distribution

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit({"device": smi, "torch": torch.__version__, "n": n})
    config.set_device("cuda")
    words = cuda_exec.seed_words(0)

    def kernel_ms(sink):
        plan = _compile.get_plan(sink)
        tape = cuda_exec.lower(plan, [sink._id]).to("cuda")
        ab = cuda_exec.recolor_transform(plan, words, n) if plan.corr_vars else None
        ms = time_ms(torch, lambda: cuda_exec.run(tape, words, n, ab))
        return {"instructions": tape.n_instr, "slots": tape.n_slots, "ms": ms}

    opcode = {name: i for i, name in enumerate(cuda_exec.OPCODES)}

    def hand_ms(k):
        """k draws summed (k = 0: one constant), stored."""
        if k == 0:
            rows = [["LOADK", 0, -1, -1], ["STORE", 0, 0, -1]]
        else:
            rows = [["DRAW", 0, 0, -1]]
            for c in range(1, k):
                rows += [["DRAW", 1, c, -1], ["ADD", 0, 0, 1]]
            rows.append(["STORE", 0, 0, -1])
        code = torch.tensor([[opcode[r[0]], *r[1:], -1, -1] for r in rows], dtype=torch.int32)
        tape = cuda_exec.Tape(code, torch.zeros(len(rows)), 2, k, (0,)).to("cuda")
        ms = time_ms(torch, lambda: cuda_exec.run(tape, words, n))
        return {"instructions": tape.n_instr, "slots": tape.n_slots, "ms": ms}

    def total(nodes):
        out = nodes[0]
        for node in nodes[1:]:
            out = out + node
        return out

    # mixed_dag_20: the first slice's breakdown, from this script.
    dag = benchmarks.mixed_dag_20()
    dag_plan = _compile.get_plan(dag)
    rows = {
        "store_only": hand_ms(0),
        "draws_8": hand_ms(8),
        "draws_8_norm": kernel_ms(total([Distribution("norm") for _ in range(8)])),
        "full": kernel_ms(dag),
    }
    emit({"graph": "mixed_dag_20", "distributions": dag_plan.d, "tapes": rows})

    # mixed_correlated_50: draws, ppfs, recolouring, transforms.
    corr = benchmarks.mixed_correlated_50()
    plan = _compile.get_plan(corr)

    def drivers():
        return [Distribution(v.distr, *v.args, **v.kwargs) for v in plan.corr_vars]

    plain = drivers()
    recoloured = drivers()
    summed = total(recoloured).correlate(*recoloured, corr_mat=plan.corr_matrix)
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    rows = {
        "draws_10": hand_ms(10),
        "draws_10_ppf": kernel_ms(total(plain)),
        "draws_10_ppf_recolour": kernel_ms(summed),
        "full": kernel_ms(corr),
        "stats_kernel": {"ms": time_ms(
            torch, lambda: cuda_exec.corr_stats(words, n, columns, "cuda"))},
    }
    emit({"graph": "mixed_correlated_50", "k": len(columns), "tapes": rows})

    # One sample() call of each path under the profiler: device time by
    # kernel, and the share of the call's wall time the card sat idle.
    for name, sink in (("mixed_dag_20", dag), ("mixed_correlated_50", corr)):
        def call():
            sink.sample(n, random_state=0, gc_strategy=[], executor="cuda")
            torch.cuda.synchronize()

        call()
        wall_ms = time_ms(torch, call)
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            call()
        device = {}
        for event in prof.key_averages():
            us = getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
            if us and event.device_type == torch.autograd.DeviceType.CUDA:
                device[event.key] = us / 1e3
        busy = float(np.sum(list(device.values())))
        emit({"profile": name, "sample_ms": wall_ms, "device_ms_by_kernel": device,
              "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms})

    # One streamed estimate of each graph under the profiler: the device
    # time of the megakernel, the statistics kernel, torch.sort's kernels
    # (the quantile rows) and everything else (the fold's reductions).
    groups = {"graph_megakernel": "graph_megakernel", "corr_stats": "corr_stats",
              "sort": "sort", "radix": "sort"}
    for name, sink in (("mixed_dag_20", dag), ("mixed_correlated_50", corr)):
        def estimate():
            sink.estimate(args.streamed_n, random_state=0, quantiles=(0.5, 0.99), cvar=(0.99,))

        estimate()
        torch.cuda.synchronize()
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            start = time.perf_counter()
            estimate()  # ends in a host read
            wall_ms = (time.perf_counter() - start) * 1e3
        device = {}
        for event in prof.key_averages():
            us = getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
            if us and event.device_type == torch.autograd.DeviceType.CUDA:
                group = next((g for key, g in groups.items() if key in event.key.lower()), "other")
                device[group] = device.get(group, 0.0) + us / 1e3
        busy = float(np.sum(list(device.values())))
        emit({"streamed_profile": name, "n": args.streamed_n, "block": 1 << 24,
              "estimate_ms": wall_ms, "device_ms_by_group": device, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / wall_ms})


if __name__ == "__main__":
    main()
