"""Where the time of the port's CUDA path goes, on one card.

    python3 tools/torch_kernel_breakdown.py [--n 100000000] [--streamed-n 268435456]

Times generated graph megakernels of graphs cut down from the two main
paths' graphs (each its own nvcc build of a few seconds, all started
together), each alone, with CUDA events (median of 10 after one warm-up),
and profiles one ``sample(executor="cuda")`` call of each path with
``torch.profiler`` for its device time and idle share, then one streamed
``estimate(quantiles, cvar)`` of each graph (``--streamed-n`` draws in
2^24-blocks), its device time grouped by what the kernels do.  The cut-down
graphs keep the main paths' distributions and drop the rest:

* ``mixed_dag_20``: a sum of two constants (the store alone), 8 standard
  uniforms summed (Philox, the bits-to-uniform map and one multiply-add a
  draw), 8 normals summed, and the full graph;
* ``mixed_correlated_50``: 10 standard uniforms summed; the 10 drivers
  with their own families, summed, uncorrelated (plus the ppfs); the
  same, correlated (plus ``SCORE``/``RECOLOR``/``NDTR``); and the full
  graph (plus the transform lattice).  The statistics kernel is
  timed beside them;
* the family branches: the Newton family graph of ``chip_smoke.py``
  phase 14 built alone first (its nvcc seconds without other builds),
  then one gamma(2.5), one beta(2, 3) and one t(7) node each alone, and
  the Newton and first closed-form family graphs, sink only;
* the table branch: one draw (a standard uniform plus 0.0) beside one
  ``TABLE_CDF`` (poisson(2000), 470 boundaries), one ``TABLE_DISCRETE``
  on the same 470 boundaries (a Discrete of poisson(2000)'s
  probabilities: the CDF row's search plus the gather of its value), one
  of 512 values, one ``TABLE_INTERP`` of 512 knots (an Empirical) and one
  of 5 (the elicited Cumulative), each plus 0.0, and ``table_risk``'s
  sink: the search's cost apart from Philox's and the store's; then each
  but the draw again, lowered without guides (the full binary search,
  ``cuda_exec.GUIDE_MAX_CELLS`` = 1): the guide's gain;
* the int32 rows: two uniforms picked into int32 operands (7 or -3 by
  ``u > 0.5``, 3 or -2) and added, beside the same two divided
  (``FloorDivide``, which the H100 computes without an integer divider),
  each plus 0.0, and ``breach_count``'s sink: the division's cost apart
  from the draws', the picks' and the store's.

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
from concurrent.futures import ThreadPoolExecutor
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
    from probabilit_tpu_torch import _build
    from probabilit_tpu_torch.models import benchmarks, graph
    from probabilit_tpu_torch.models.distributions import (
        CumulativeDistribution,
        DiscreteDistribution,
        Distribution,
        EmpiricalDistribution,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit({"device": smi, "torch": torch.__version__, "n": n})
    config.set_device("cuda")
    words = cuda_exec.seed_words(0)

    def tape_of(sink):
        plan = _compile.get_plan(sink)
        return plan, cuda_exec.lowered(plan, [sink._id], "cuda")

    def kernel_ms(sink):
        plan, tape = tape_of(sink)
        ab = cuda_exec.recolor_transform(plan, words, n) if plan.corr_vars else None
        ms = time_ms(torch, lambda: cuda_exec.run(tape, words, n, ab))
        return {"rows": tape.n_instr, "constants": len(tape.consts), "ms": ms}

    def uniforms(k):
        """k standard uniforms summed (k = 0: two constants summed)."""
        if k == 0:
            return graph.Constant(1.5) + graph.Constant(2.0)
        return total([Distribution("uniform") for _ in range(k)])

    def total(nodes):
        out = nodes[0]
        for node in nodes[1:]:
            out = out + node
        return out

    dag = benchmarks.mixed_dag_20()
    dag_plan = _compile.get_plan(dag)
    corr = benchmarks.mixed_correlated_50()
    plan = _compile.get_plan(corr)

    def drivers():
        return [Distribution(v.distr, *v.args, **v.kwargs) for v in plan.corr_vars]

    recoloured = drivers()
    dag_cuts = {
        "store_only": uniforms(0),
        "draws_8": uniforms(8),
        "draws_8_norm": total([Distribution("norm") for _ in range(8)]),
        "full": dag,
    }
    corr_cuts = {
        "draws_10": uniforms(10),
        "draws_10_ppf": total(drivers()),
        "draws_10_ppf_recolour": total(recoloured).correlate(
            *recoloured, corr_mat=plan.corr_matrix),
        "full": corr,
    }

    families = benchmarks.family_graphs()
    family_cuts = {
        "gamma_1": Distribution("gamma", 2.5) + 0.0,
        "beta_1": Distribution("beta", 2.0, 3.0) + 0.0,
        "t_1": Distribution("t", 7.0) + 0.0,
        "newton_graph": families["newton"][0],
        "closed_form_0_graph": families["closed_form_0"][0],
    }

    poisson_cdf, poisson_loc = cuda_exec.trimmed_cdf_table(Distribution("poisson", mu=2000))

    def table_graphs():
        """Fresh table graphs (a plan caches its tape, so each lowering
        needs its own)."""
        rng = np.random.default_rng(8)
        return {
            "draw_1": Distribution("uniform") + 0.0,
            "table_cdf_471": benchmarks.large_table(),
            "table_discrete_471": DiscreteDistribution(
                np.arange(len(poisson_cdf)) + poisson_loc,
                np.diff(poisson_cdf.astype(np.float64), prepend=0.0)) + 0.0,
            "table_discrete_512": DiscreteDistribution(
                np.arange(512.0), rng.dirichlet(np.ones(512))) + 0.0,
            "table_interp_512": EmpiricalDistribution(rng.lognormal(size=512)) + 0.0,
            "table_interp_5": CumulativeDistribution(
                [0.0, 0.1, 0.5, 0.9, 1.0], [10.0, 15.0, 20.0, 25.0, 40.0]) + 0.0,
            "table_risk": benchmarks.table_risk()[0],
        }

    table_cuts = table_graphs()

    def picked(u, a, b):
        return (u > 0.5) * a + (u <= 0.5) * b

    u1, u2 = Distribution("uniform"), Distribution("uniform")
    v1, v2 = Distribution("uniform"), Distribution("uniform")
    typed_cuts = {
        "int_add": (picked(u1, 7, -3) + picked(u2, 3, -2)) + 0.0,
        "int_floordiv": (picked(v1, 7, -3) // picked(v2, 3, -2)) + 0.0,
        "breach_count": benchmarks.breach_count()[0],
    }

    def timed_build(text):
        t = time.perf_counter()
        _build.build_generated("graph_megakernel", text, cuda_exec._HEADERS)
        return time.perf_counter() - t

    # The Newton family graph alone, before any other build runs.
    emit({"build_alone": "newton_graph",
          "seconds": timed_build(tape_of(family_cuts["newton_graph"])[1].source)})

    # The same table graphs lowered without guides.
    default = cuda_exec.GUIDE_MAX_CELLS
    cuda_exec.GUIDE_MAX_CELLS = 1
    full_search = {f"{name}, full search": sink for name, sink in table_graphs().items()
                   if name != "draw_1"}
    for sink in full_search.values():
        tape_of(sink)
    cuda_exec.GUIDE_MAX_CELLS = default

    # Every cut is its own generated kernel: build them all at once.
    texts = [tape_of(sink)[1].source
             for sink in (*dag_cuts.values(), *corr_cuts.values(), *family_cuts.values(),
                          *table_cuts.values(), *full_search.values(), *typed_cuts.values())]

    start = time.perf_counter()
    with ThreadPoolExecutor(len(texts) + 1) as pool:
        stats_build = pool.submit(_build.build, "corr_stats")
        seconds_each = list(pool.map(timed_build, texts))
        stats_build.result()
    emit({"builds": len(texts) + 1, "seconds_all": time.perf_counter() - start,
          "seconds_each_generated": seconds_each})

    rows = {name: kernel_ms(sink) for name, sink in dag_cuts.items()}
    emit({"graph": "mixed_dag_20", "distributions": dag_plan.d, "kernels": rows})

    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    rows = {name: kernel_ms(sink) for name, sink in corr_cuts.items()}
    rows["stats_kernel"] = {"ms": time_ms(
        torch, lambda: cuda_exec.corr_stats(words, n, columns, "cuda"))}
    emit({"graph": "mixed_correlated_50", "k": len(columns), "kernels": rows})

    rows = {name: kernel_ms(sink) for name, sink in family_cuts.items()}
    emit({"graph": "family_branches", "kernels": rows})

    rows = {name: {**kernel_ms(sink), "shared_bytes": tape_of(sink)[1].shared_bytes,
                   "guides": [guide[2:] for guide in tape_of(sink)[1].guides]}
            for name, sink in {**table_cuts, **full_search}.items()}
    emit({"graph": "table_branch", "kernels": rows})

    rows = {name: kernel_ms(sink) for name, sink in typed_cuts.items()}
    emit({"graph": "typed_rows", "kernels": rows})

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
