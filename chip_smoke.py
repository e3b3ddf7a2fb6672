"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main path, ``mixed_dag_20().sample(1e8, gc_strategy=[],
executor="cuda")``, through the hand-written CUDA kernel, and checks it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernel from ``probabilit_tpu_torch/csrc`` with nvcc;
3. samples the flagship graph at n = 1e8 and asserts that the kernel was
   launched, that the sink is finite, of shape (1e8,), and on the card;
4. holds the kernel against its plain PyTorch twin (``run_reference``:
   the same Philox bits, the same tape) at the main path's shape, and per
   node at n = 2^22;
5. KS-tests a normal through ``executor="cuda"`` against scipy's CDF, and
   compares the sink's mean and std with ``executor=None`` at 1e7;
6. times the kernel, its twin and both executors at 1e8 with CUDA events
   (median of 5 after one warm-up).

Every line but the last is one JSON object; the line before the last
holds the kernels' record.  The last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero.  It needs the repository beside it and a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_MAIN = 100_000_000
N_NODES = 1 << 22
N_KS = 500_000
N_MOMENTS = 10_000_000
REL_TOL = 1e-4  # per kept node: max |kernel - twin| <= REL_TOL * max |twin|
KS_P_MIN = 0.01
SE_MAX = 5.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, message):
    if not cond:
        raise AssertionError(message)


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

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_path, log = _build.build("graph_megakernel")
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "library": lib_path.name,
          "ptxas": [line for line in log.splitlines() if "ptxas" in line]})

    config.set_device("cuda")
    config.set_dtype(torch.float32)

    # Phase 3: the main path, through the entry point a user calls.
    sink = mixed_dag_20()
    cuda_exec.LAUNCHES = 0
    out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
    torch.cuda.synchronize()
    launches = cuda_exec.LAUNCHES
    check(launches >= 1, "the main path launched no kernel")
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

    emit({"kernels": [{
        "name": "graph_megakernel",
        "route": "cuda",
        "source": "probabilit_tpu_torch/csrc/graph_megakernel.cu",
        "replaces": "probabilit_tpu/engine/pallas_exec.py:515",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
