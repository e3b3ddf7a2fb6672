"""The scenario axis of ``sweep``, measured on one card: a loop over the
scenarios against one batched evaluation.

    python3 tools/torch_sweep_rule.py [--n 1048576] [--scenarios 64]

``engine/sweep.py`` picks one of two designs by the graph's structure
(``_batchable``): a loop that evaluates the plain executor's body once a
scenario, or one batched evaluation with the swept slot written as an
``(S, 1)`` column, so that every node downstream gives ``(S, n)``
(``_scenario_rows``).  ``mixed_dag_20``'s price scale takes the batch;
this runs both designs on it.  For that ladder (``chip_smoke.py`` phase 22 (a): 64 scales of the lognormal price,
one drawn matrix of n rows) this prints the loop's and the batched
evaluation's wall ms (CUDA events, median of 5 after a warm-up) for the
mean alone and for mean, q0.95 and cvar0.95, one scenario's evaluation
beside them, each with its device ms, kernel launches and idle share
(``torch.profiler``) and peak memory, and the largest difference of the
two designs' statistics relative to max(1, |value|).  One JSON object a
line, the card's ``nvidia-smi`` name and power limit first.  Needs a CUDA
card; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1 << 20)
    parser.add_argument("--scenarios", type=int, default=64)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; torch.cuda.is_available() is False.")
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import sweep as sweep_mod
    from probabilit_tpu_torch.models.benchmarks import mixed_dag_20
    from probabilit_tpu_torch.ops import qmc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit({"tool": "torch_sweep_rule", "card": smi, "torch": torch.__version__,
          "n": args.n, "scenarios": args.scenarios})
    config.set_device("cuda")
    sink = mixed_dag_20()
    plan = _compile.get_plan(sink)
    price = plan.isns[0]  # lognorm(s=0.25, scale=50)
    pairs = [(price, "scale")]
    assert sweep_mod._batchable(plan, pairs, True)
    theta = torch.linspace(40.0, 60.0, args.scenarios, device="cuda")[:, None]
    q = qmc.uniform(22, args.n, plan.d, torch.float32, "cuda")
    body = sweep_mod._sweep_body(plan, _compile.resolve_correlator("imanconover"), True)

    def design(batched, stats, scenarios):
        rows = sweep_mod._scenario_rows(body, plan, pairs, theta[:scenarios], q, batched)
        return torch.cat([stats(y) for y in rows], dim=1).cpu().numpy()

    designs = {}
    for label, names in (("mean", ["mean"]), ("mean_q_cvar", ["mean", "q0.95", "cvar0.95"])):
        stats = sweep_mod._row_statistics(names, False)
        for kind, batched in (("loop", False), ("batched", True)):
            designs[f"{kind}_{label}"] = (
                lambda b=batched, st=stats: design(b, st, args.scenarios))
        designs[f"one_scenario_{label}"] = lambda st=stats: design(False, st, 1)
    for label, fn in designs.items():
        fn()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        profiled = start.elapsed_time(end)
        busy = launches = 0.0
        for event in prof.key_averages():
            us = getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
            if us and event.device_type == torch.autograd.DeviceType.CUDA:
                busy += us / 1e3
                launches += event.count
        emit({"design": label, "card": smi, "ms_median_of_5": statistics.median(times),
              "ms_all": times, "profiled_ms": profiled, "device_ms": busy,
              "kernel_launches": int(launches), "idle_share": 1.0 - busy / profiled,
              "peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20})
    loop_stats = designs["loop_mean_q_cvar"]()
    batch_stats = designs["batched_mean_q_cvar"]()
    diff = np.abs(loop_stats - batch_stats) / np.maximum(1.0, np.abs(loop_stats))
    emit({"loop_vs_batched_max_rel": float(diff.max()), "card": smi})


if __name__ == "__main__":
    main()
