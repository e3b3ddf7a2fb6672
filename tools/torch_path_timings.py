"""End-to-end times of the port's two main paths, for A/B runs on one card.

    python3 tools/torch_path_timings.py [--root DIR] [--repeats 5]

Imports ``probabilit_tpu_torch`` from ``--root`` (default: this
repository), so one call on the card can time two checkouts in turns
(parent, change, change, parent).  Times, with CUDA events or the host
clock around calls that end in a host read (median of ``--repeats`` after
one warm-up): ``sample(1e8, gc_strategy=[], executor="cuda")`` of
``mixed_dag_20`` and ``mixed_correlated_50``, K1 (and K2) alone at 1e8,
and ``estimate(1e9)`` of both graphs with quantiles (0.5, 0.99) and CVaR
0.99 and without.  Prints one JSON object per line, the card's
``nvidia-smi`` name and power limit first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; torch.cuda.is_available() is False.")
    import probabilit_tpu_torch
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import cuda_exec
    from probabilit_tpu_torch.models.benchmarks import mixed_correlated_50, mixed_dag_20

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit({"device": smi, "package": str(Path(probabilit_tpu_torch.__file__).parent)})
    config.set_device("cuda")
    n, n_stream = 100_000_000, 1_000_000_000
    words = cuda_exec.seed_words(0)

    def events_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.repeats):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def wall_ms(fn):
        fn()
        times = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()  # ends in a host read
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    for name, build in (("mixed_dag_20", mixed_dag_20), ("mixed_correlated_50", mixed_correlated_50)):
        sink = build()
        plan = _compile.get_plan(sink)
        tape = cuda_exec.lowered(plan, [sink._id], "cuda")
        record = {"graph": name, "card": smi, "n": n}
        ab = None
        if plan.corr_vars:
            columns = [plan.col_of[v._id] for v in plan.corr_vars]
            ab = cuda_exec.recolor_transform(plan, words, n, "cuda")
            record["k2_ms"] = events_ms(lambda: cuda_exec.corr_stats(words, n, columns, "cuda"))
        record["k1_ms"] = events_ms(lambda: cuda_exec.run(tape, words, n, ab))
        record["sample_ms"] = events_ms(
            lambda: sink.sample(n, random_state=0, gc_strategy=[], executor="cuda"))
        record["estimate_1e9_quantiles_ms"] = wall_ms(lambda: sink.estimate(
            n_stream, random_state=0, quantiles=(0.5, 0.99), cvar=(0.99,)))
        record["estimate_1e9_ms"] = wall_ms(lambda: sink.estimate(n_stream, random_state=0))
        emit(record)


if __name__ == "__main__":
    main()
