"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's two main paths through the hand-written CUDA kernels
and checks them.  The flagship path, ``mixed_dag_20().sample(1e8,
gc_strategy=[], executor="cuda")``, runs the graph megakernel:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels from ``probabilit_tpu_torch/csrc`` with nvcc, one
   process per source, all started together, and prints ptxas's register
   and spill counts;
3. samples the flagship graph at n = 1e8 and asserts that the kernel was
   launched, that the sink is finite, of shape (1e8,), and on the card;
4. holds the kernel against its plain PyTorch twin (``run_reference``:
   the same Philox bits, the same tape) at the main path's shape, and per
   node at n = 2^22;
5. KS-tests a normal through ``executor="cuda"`` against scipy's CDF, and
   compares the sink's mean and std with ``executor=None`` at 1e7;
6. times the kernel, its twin and both executors at 1e8 with CUDA events
   (median of 5 after one warm-up).

The correlated path, ``mixed_correlated_50().sample(1e8, gc_strategy=[],
executor="cuda")`` (NCM repair, then sort-free Iman-Conover), runs the
correlation-statistics kernel and the megakernel's recolour branch:

7. samples it at n = 1e8 and asserts that both kernels were launched and
   the sink is finite, of shape (1e8,), and on the card;
8. holds the statistics kernel against its twin (each sum within 1e-5 * n)
   and the recoloured megakernel against its twin given the same
   recolour transform (1e-4 of max |twin| per kept node), at 1e8 and per
   node at 2^22;
9. checks at 1e7 that the three normal drivers' sample correlation is the
   repaired target within 2e-3 (their values are linear in the
   recoloured scores), and that the sink's mean and std through
   ``executor="cuda"`` and ``executor=None`` agree within 5 standard errors;
10. times both kernels, their twins, both executors and the host share at
    1e8.

Every line but the last is one JSON object; the line before the last
holds the kernels' record, with each kernel's bound: the larger of its
bytes over 3.35 TB/s and its operations over the card's rates (integer
instructions at 132 SMs x 64 lanes x 1.98 GHz; float32 operations, an FMA
counting two, at 67 TFLOP/s), counted per sample by ``OP_COST`` below.  The last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero.  It needs the repository beside it and a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N_MAIN = 100_000_000
N_NODES = 1 << 22
N_KS = 500_000
N_MOMENTS = 10_000_000
REL_TOL = 1e-4  # per kept node: max |kernel - twin| <= REL_TOL * max |twin|
STATS_TOL = 1e-5  # per sum of n terms of magnitude ~1: |kernel - twin| <= STATS_TOL * n
CORR_TOL = 2e-3
KS_P_MIN = 0.01
SE_MAX = 5.0
KERNELS = ("graph_megakernel", "corr_stats")

# The card's rates for the bound (NVIDIA H100 SXM, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # 64 INT32 lanes per SM at the 1980 MHz max clock
FP32_FLOPS = 67e12  # an FMA counts two

# Per-sample work of one tape instruction: (32-bit integer instructions,
# float32 flops).  A Philox4x32-10 draw is 10 rounds of two IMAD.WIDE and
# two 3-input XORs, plus the counter and the bits-to-uniform map;
# ndtri_fast is about 50 flops (two 9-term Horner polynomials, a log, a
# sqrt); ndtr_fast about 25 (a 5-term polynomial, a division, an exp).
# Transcendentals count 4 flops.  This is a floor, not a model of the
# instruction stream: the interpreter's own loads and branches are left out.
_NDTRI, _NDTR = 50, 25
OP_COST = {
    "DRAW": (43, 3), "LOADK": (0, 0), "STORE": (0, 0),
    "SCORE": (0, _NDTRI), "NDTR": (0, _NDTR + 2),
    "PPF_UNIFORM": (0, 2), "PPF_NORM": (0, _NDTRI + 2), "PPF_EXPON": (0, 6),
    "PPF_LOGNORM": (0, _NDTRI + 7), "PPF_TRIANG": (0, 14),
    "SCORE_NORM": (0, 2), "SCORE_LOGNORM": (0, 7),
    "DIV": (0, 4), "POW": (0, 8), "EXP": (0, 4), "LOG": (0, 4), "SQRT": (0, 4),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, message):
    if not cond:
        raise AssertionError(message)


def tape_cost(tape, cuda_exec):
    """(integer instructions, float32 flops) per sample of ``tape``."""
    ints = flops = 0
    for op in tape.code[:, 0].tolist():
        name = cuda_exec.OPCODES[op]
        if name == "RECOLOR":
            i, f = 0, 2 * tape.n_corr
        else:
            i, f = OP_COST.get(name, (0, 1))
        ints, flops = ints + i, flops + f
    return ints, flops


def stats_cost(k):
    """(integer instructions, float32 flops) per sample of the statistics
    kernel with k columns: k draws and scores, then k + k(k+1)/2 sums."""
    return 43 * k, k * (3 + _NDTRI + 1) + 2 * (k * (k + 1) // 2)


def bound(n, nbytes, cost):
    """The least time, ms, for n samples: bytes or operations, whichever binds."""
    ints, flops = cost
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": max(n * ints / INT32_OPS_PER_S, n * flops / FP32_FLOPS)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def cuda_time_ms(fn, repeats=5):
    """Median wall time of ``fn`` on the card, by CUDA events, after one
    warm-up call."""
    import torch

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
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False.")
    import probabilit_tpu_torch
    here = Path(__file__).resolve().parent
    if Path(probabilit_tpu_torch.__file__).resolve().parent.parent != here:
        raise SystemExit("chip_smoke.py must run from the repository that holds it.")

    import numpy as np
    import scipy.stats

    from probabilit_tpu_torch import _build, config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import cuda_exec
    from probabilit_tpu_torch.models.benchmarks import mixed_dag_20
    from probabilit_tpu_torch.models.distributions import Distribution

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # Phase 2: build, one nvcc per source, all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    build_s = time.perf_counter() - t0
    for name, (lib_path, log) in built.items():
        lines = log.splitlines()
        emit({"phase": "build", "kernel": name, "seconds": build_s, "library": lib_path.name,
              "spill_lines": [line for line in lines if "spill" in line],
              "ptxas": [line for line in lines if "ptxas" in line and "spill" not in line]})

    config.set_device("cuda")
    config.set_dtype(torch.float32)

    # Phase 3: the main path, through the entry point a user calls.
    sink = mixed_dag_20()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
    torch.cuda.synchronize()
    launches = cuda_exec.LAUNCHES
    check(launches >= 1, "the main path launched no kernel")
    check(cuda_exec.STATS_LAUNCHES == 0, "an uncorrelated graph ran the statistics kernel")
    check(out.device.type == "cuda", f"sink lies on {out.device}")
    check(tuple(out.shape) == (N_MAIN,), f"sink shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite sink values")
    emit({"phase": "main_path", "n": N_MAIN, "launches": launches,
          "sink_mean": out.double().mean().item(), "sink_std": out.double().std().item()})

    # Phase 4: kernel against its plain twin on identical Philox bits.
    plan = _compile.get_plan(sink)
    words = cuda_exec.seed_words(0)
    main_tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, {sink._id})).to("cuda")
    twin = cuda_exec.run_reference(main_tape, words, N_MAIN)[0]
    main_err = (out - twin).abs().max().item()
    main_scale = twin.abs().max().item()
    check(main_err <= REL_TOL * main_scale,
          f"main path: kernel vs twin {main_err} > {REL_TOL} * {main_scale}")
    emit({"phase": "kernel_vs_twin_main", "n": N_MAIN, "max_abs_err": main_err,
          "max_abs_twin": main_scale, "tolerance": REL_TOL * main_scale})
    del twin

    keep = [node for node in plan.topo if not hasattr(node, "value")][-16:]
    keep_ids = frozenset(node._id for node in keep) | {sink._id}
    node_tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, keep_ids)).to("cuda")
    got, _ = cuda_exec.run(node_tape, words, N_NODES)
    U = cuda_exec.philox_uniforms(words, N_NODES, plan.d, device="cuda")
    ref = cuda_exec.run_tape(node_tape, U)
    central = ((U >= 0.01) & (U <= 0.99)).all(dim=1)
    by_id = {node._id: node for node in plan.topo}
    per_node = []
    for k, nid in enumerate(node_tape.keep_order):
        err = (got[k] - ref[k]).abs()
        scale = ref[k].abs().max().item()
        row = {"node": f"{type(by_id[nid]).__name__}#{k}", "max_abs_err": err.max().item(),
               "central_max_abs_err": err[central].max().item(), "max_abs_twin": scale,
               "rel_err": err.max().item() / max(scale, 1e-30)}
        per_node.append(row)
        check(row["max_abs_err"] <= REL_TOL * scale, f"kernel vs twin per node: {row}")
    emit({"phase": "kernel_vs_twin_nodes", "n": N_NODES, "rel_tolerance": REL_TOL,
          "central": "all 8 uniforms in [0.01, 0.99]", "nodes": per_node})
    del U, ref, got

    # Phase 5: statistics of the kernel's stream.
    s = Distribution("norm", loc=3.0, scale=2.0).sample(
        N_KS, random_state=7, gc_strategy=[], executor="cuda"
    ).double().cpu().numpy()
    ks = scipy.stats.kstest(s, scipy.stats.norm(loc=3.0, scale=2.0).cdf)
    check(ks.pvalue > KS_P_MIN, f"KS p-value {ks.pvalue}")
    moments = {}
    for executor in ("cuda", None):
        x = sink.sample(N_MOMENTS, random_state=1, gc_strategy=[], executor=executor).double()
        m, sd = x.mean().item(), x.std().item()
        m4 = ((x - m) ** 4).mean().item()
        # Standard errors of the mean and of the std (delta method).
        moments[str(executor)] = (m, sd, sd / np.sqrt(N_MOMENTS),
                                  np.sqrt((m4 - sd**4) / N_MOMENTS) / (2 * sd))
    (m1, s1, se_m1, se_s1), (m2, s2, se_m2, se_s2) = moments["cuda"], moments["None"]
    se_mean, se_std = np.hypot(se_m1, se_m2), np.hypot(se_s1, se_s2)
    check(abs(m1 - m2) <= SE_MAX * se_mean, f"sink mean {m1} vs {m2}")
    check(abs(s1 - s2) <= SE_MAX * se_std, f"sink std {s1} vs {s2}")
    emit({"phase": "statistics", "ks_n": N_KS, "ks_pvalue": ks.pvalue,
          "ks_mean_err": abs(s.mean() - 3.0), "ks_std_err": abs(s.std() - 2.0),
          "moments_n": N_MOMENTS, "mean_cuda": m1, "mean_plain": m2,
          "mean_diff_se": abs(m1 - m2) / se_mean, "std_cuda": s1, "std_plain": s2,
          "std_diff_se": abs(s1 - s2) / se_std})

    # Phase 6: timings at the main path's shape, on this card.
    kernel_ms = cuda_time_ms(lambda: cuda_exec.run(main_tape, words, N_MAIN))
    twin_ms = cuda_time_ms(lambda: cuda_exec.run_reference(main_tape, words, N_MAIN), repeats=3)
    cuda_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda"))
    plain_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor=None))
    emit({"phase": "timing", "card": smi, "n": N_MAIN,
          "kernel_ms": kernel_ms, "twin_ms": twin_ms,
          "sample_cuda_ms": cuda_ms, "sample_plain_ms": plain_ms,
          "samples_per_sec_cuda": N_MAIN / (cuda_ms * 1e-3),
          "samples_per_sec_plain": N_MAIN / (plain_ms * 1e-3)})

    main_ints, main_flops = tape_cost(main_tape, cuda_exec)
    main_bound, main_by = bound(N_MAIN, 4 * N_MAIN, (main_ints, main_flops))
    emit({"phase": "bound", "graph": "mixed_dag_20", "n": N_MAIN,
          "int_instr_per_sample": main_ints, "flops_per_sample": main_flops,
          "bytes": 4 * N_MAIN, "bound_ms": main_bound, "bound_by": main_by})
    del out

    corr = correlated_path(torch, np, cuda_exec, _compile, smi)

    emit({"kernels": [
        {
            "name": "graph_megakernel",
            "route": "cuda",
            "source": "probabilit_tpu_torch/csrc/graph_megakernel.cu",
            "replaces": "probabilit_tpu/engine/pallas_exec.py:515",
            "launches": launches + corr["k1_launches"],
            "max_abs_err": max(main_err, corr["k1_err"]),
            "ms": kernel_ms,
            "plain_ms": twin_ms,
            "bound_ms": main_bound,
            "bound_by": main_by,
            "library_ms": None,
        },
        {
            "name": "corr_stats",
            "route": "cuda",
            "source": "probabilit_tpu_torch/csrc/corr_stats.cu",
            "replaces": "probabilit_tpu/engine/pallas_exec.py:577",
            "launches": corr["k2_launches"],
            "max_abs_err": corr["k2_err"],
            "ms": corr["k2_ms"],
            "plain_ms": corr["k2_twin_ms"],
            "bound_ms": corr["k2_bound_ms"],
            "bound_by": corr["k2_bound_by"],
            "library_ms": None,
        },
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def correlated_path(torch, np, cuda_exec, _compile, smi):
    """Phases 7-10: ``mixed_correlated_50`` through both kernels."""
    from probabilit_tpu_torch.models.benchmarks import mixed_correlated_50

    # Phase 7: the correlated main path, through the entry point a user calls.
    sink = mixed_correlated_50()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
    torch.cuda.synchronize()
    k1_launches, k2_launches = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    check(k1_launches >= 1, "the correlated path launched no megakernel")
    check(k2_launches >= 1, "the correlated path launched no statistics kernel")
    check(out.device.type == "cuda", f"sink lies on {out.device}")
    check(tuple(out.shape) == (N_MAIN,), f"sink shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite sink values")
    emit({"phase": "correlated_main_path", "n": N_MAIN, "megakernel_launches": k1_launches,
          "stats_launches": k2_launches, "sink_mean": out.double().mean().item(),
          "sink_std": out.double().std().item()})

    # Phase 8: both kernels against their twins on identical Philox bits.
    plan = _compile.get_plan(sink)
    K = len(plan.corr_vars)
    words = cuda_exec.seed_words(0)
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    sums = cuda_exec.corr_stats(words, N_MAIN, columns, "cuda")
    sums_twin = cuda_exec.corr_stats_reference(words, N_MAIN, columns, "cuda")
    k2_err = (sums - sums_twin).abs().max().item()
    check(k2_err <= STATS_TOL * N_MAIN, f"statistics kernel vs twin {k2_err} > {STATS_TOL} * n")
    emit({"phase": "stats_vs_twin", "n": N_MAIN, "k": K, "sums": sums.numel(),
          "max_abs_err": k2_err, "tolerance": STATS_TOL * N_MAIN,
          "max_rel_err": ((sums - sums_twin).abs() / sums_twin.abs().clamp(min=1.0)).max().item()})

    ab = cuda_exec.recolor_transform(plan, words, N_MAIN, device="cuda")
    main_tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, {sink._id})).to("cuda")
    twin = cuda_exec.run_reference(main_tape, words, N_MAIN, ab)[0]
    k1_err = (out - twin).abs().max().item()
    scale = twin.abs().max().item()
    check(k1_err <= REL_TOL * scale, f"recoloured kernel vs twin {k1_err} > {REL_TOL} * {scale}")
    emit({"phase": "recoloured_kernel_vs_twin_main", "n": N_MAIN, "max_abs_err": k1_err,
          "max_abs_twin": scale, "tolerance": REL_TOL * scale})
    del twin

    keep_ids = frozenset([sink._id] + [v._id for v in plan.corr_vars])
    others = [n._id for n in plan.topo if n._id not in keep_ids and not hasattr(n, "value")]
    keep_ids |= set(others[-(16 - len(keep_ids)):])
    node_tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, keep_ids)).to("cuda")
    ab_nodes = cuda_exec.recolor_transform(plan, words, N_NODES, device="cuda")
    got, _ = cuda_exec.run(node_tape, words, N_NODES, ab_nodes)
    ref = cuda_exec.run_reference(node_tape, words, N_NODES, ab_nodes)
    by_id = {node._id: node for node in plan.topo}
    per_node = []
    for k, nid in enumerate(node_tape.keep_order):
        err = (got[k] - ref[k]).abs().max().item()
        node_scale = ref[k].abs().max().item()
        row = {"node": f"{type(by_id[nid]).__name__}#{k}", "max_abs_err": err,
               "max_abs_twin": node_scale, "rel_err": err / max(node_scale, 1e-30)}
        per_node.append(row)
        check(err <= REL_TOL * node_scale, f"recoloured kernel vs twin per node: {row}")
    emit({"phase": "recoloured_kernel_vs_twin_nodes", "n": N_NODES, "rel_tolerance": REL_TOL,
          "nodes": per_node})
    del got, ref

    # Phase 9: the induced correlation and the executors' moments at 1e7.
    normals = [v for v in plan.corr_vars if v.distr == "norm"]
    idx = [plan.corr_vars.index(v) for v in normals]
    sink.sample(N_MOMENTS, random_state=2, gc_strategy=normals, executor="cuda")
    got_corr = torch.corrcoef(torch.stack([v.samples_ for v in normals]).double()).cpu().numpy()
    target = plan.corr_matrix[np.ix_(idx, idx)]
    corr_err = float(np.abs(got_corr - target).max())
    check(corr_err <= CORR_TOL, f"normal drivers' correlation off the target by {corr_err}")
    moments = {}
    for executor in ("cuda", None):
        x = sink.sample(N_MOMENTS, random_state=1, gc_strategy=[], executor=executor).double()
        m, sd = x.mean().item(), x.std().item()
        m4 = ((x - m) ** 4).mean().item()
        moments[str(executor)] = (m, sd, sd / np.sqrt(N_MOMENTS),
                                  np.sqrt((m4 - sd**4) / N_MOMENTS) / (2 * sd))
    (m1, s1, se_m1, se_s1), (m2, s2, se_m2, se_s2) = moments["cuda"], moments["None"]
    se_mean, se_std = np.hypot(se_m1, se_m2), np.hypot(se_s1, se_s2)
    check(abs(m1 - m2) <= SE_MAX * se_mean, f"correlated sink mean {m1} vs {m2}")
    check(abs(s1 - s2) <= SE_MAX * se_std, f"correlated sink std {s1} vs {s2}")
    emit({"phase": "correlated_statistics", "n": N_MOMENTS, "normal_drivers": len(normals),
          "corr_max_abs_err": corr_err, "corr_tolerance": CORR_TOL,
          "mean_cuda": m1, "mean_plain": m2, "mean_diff_se": abs(m1 - m2) / se_mean,
          "std_cuda": s1, "std_plain": s2, "std_diff_se": abs(s1 - s2) / se_std})

    # Phase 10: timings at the main path's shape, on this card.
    k2_ms = cuda_time_ms(lambda: cuda_exec.corr_stats(words, N_MAIN, columns, "cuda"))
    k2_twin_ms = cuda_time_ms(
        lambda: cuda_exec.corr_stats_reference(words, N_MAIN, columns, "cuda"), repeats=3)
    k1_ms = cuda_time_ms(lambda: cuda_exec.run(main_tape, words, N_MAIN, ab))
    k1_twin_ms = cuda_time_ms(
        lambda: cuda_exec.run_reference(main_tape, words, N_MAIN, ab), repeats=3)
    transform_ms = cuda_time_ms(
        lambda: cuda_exec.recolor_transform(plan, words, N_MAIN, device="cuda"))
    cuda_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda"))
    plain_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor=None), repeats=3)
    host_ms = cuda_ms - k1_ms - k2_ms
    k2_bytes = 4 * sums.numel() * cuda_exec.stats_grid(K, N_MAIN)  # the partials written
    k2_bound_ms, k2_bound_by = bound(N_MAIN, k2_bytes, stats_cost(K))
    k1_cost = tape_cost(main_tape, cuda_exec)
    k1_bound_ms, k1_bound_by = bound(N_MAIN, 4 * N_MAIN, k1_cost)
    emit({"phase": "correlated_timing", "card": smi, "n": N_MAIN, "k": K,
          "stats_kernel_ms": k2_ms, "stats_twin_ms": k2_twin_ms,
          "recolor_transform_ms": transform_ms, "solve_and_sync_ms": transform_ms - k2_ms,
          "megakernel_ms": k1_ms, "megakernel_twin_ms": k1_twin_ms,
          "sample_cuda_ms": cuda_ms, "sample_plain_ms": plain_ms,
          "host_ms": host_ms, "host_share": host_ms / cuda_ms,
          "samples_per_sec_cuda": N_MAIN / (cuda_ms * 1e-3),
          "samples_per_sec_plain": N_MAIN / (plain_ms * 1e-3),
          "stats_bound_ms": k2_bound_ms, "stats_bound_by": k2_bound_by,
          "stats_int_instr_per_sample": stats_cost(K)[0],
          "stats_flops_per_sample": stats_cost(K)[1],
          "megakernel_bound_ms": k1_bound_ms, "megakernel_bound_by": k1_bound_by,
          "megakernel_int_instr_per_sample": k1_cost[0],
          "megakernel_flops_per_sample": k1_cost[1], "tape_instructions": main_tape.n_instr})
    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "k1_err": k1_err,
            "k2_err": k2_err, "k2_ms": k2_ms, "k2_twin_ms": k2_twin_ms,
            "k2_bound_ms": k2_bound_ms, "k2_bound_by": k2_bound_by}


if __name__ == "__main__":
    main()
