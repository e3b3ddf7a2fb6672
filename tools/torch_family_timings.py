"""K1 of the family branches, graph by graph and family by family, on one card.

    python3 tools/torch_family_timings.py [--root DIR] [--repeats 5] [--singles]
        [--library] [--caps 2,3] [--tables] [--guides 0,4:2]

Imports ``probabilit_tpu_torch`` from ``--root`` (default: this
repository), so one call on the card can time two checkouts in turns
(parent, change, change, parent).  Builds every kernel it times first,
one nvcc per text, all started together, then times K1 alone at n = 1e8
(CUDA events, median of ``--repeats`` after one warm-up) of:

* the four closed-form family graphs of ``chip_smoke.py`` phase 14
  (``benchmarks.family_graphs()``, sink only), ``mixed_dag_20``,
  ``mixed_correlated_50`` (its recolour transform solved once),
  ``breach_count`` and ``portfolio_var``;
* with ``--singles``, each of the 62 closed-form families alone (one
  node, at ``chip_smoke.LIBRARY_FAMILIES``' parameters, else
  ``FAMILY_SWEEP``'s, else ``SINGLE_ARGS``');
* with ``--library``, the eleven families that ``torch.distributions``
  inverts (``chip_smoke.LIBRARY_FAMILIES``): its ``icdf`` on the kernel's own uniforms
  (drawn beforehand), plus loc and scale where the class has none, beside
  K1 of the same family alone, and the largest difference between the two;
* with ``--caps``, the four closed-form graphs rebuilt with
  ``__launch_bounds__(kThreads, m)`` for each m, timed beside the
  generator's own text;
* with ``--tables``, the three table graphs of ``chip_smoke.py`` phase 16
  (``large_table``, ``table_risk``, ``table_risk_correlated``, sink only)
  and, with ``--guides 0,4:2``, each also lowered with other guides,
  where the package has them: ``SPREAD:WINDOW[:MIN]`` sets
  ``cuda_exec.GUIDE_SPREAD``, ``GUIDE_WINDOW`` and
  ``GUIDE_MIN_BOUNDARIES``, and 0 means no guide (the full search).

It also builds, untimed, the Newton family graph's, the three table
graphs' and the statistics kernel (K2), for ``tools/torch_sass_compare.py``.
For each kernel it prints its registers and local memory
(``cuobjdump -res-usage``) and its SASS instructions, ``CALL``s,
``STL``/``LDL``s and ``MUFU``s (``cuobjdump -sass``).  One JSON object per
line, the card's ``nvidia-smi`` name and power limit first.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N = 100_000_000
# The families alone take LIBRARY_FAMILIES' parameters (chip_smoke.py),
# else FAMILY_SWEEP's, else these.
SINGLE_ARGS = {"triang": ((0.4,), {"loc": 1.0, "scale": 2.0})}
HERE = Path(__file__).resolve().parent.parent


def emit(obj):
    print(json.dumps(obj), flush=True)


def chip_smoke():
    """This repository's chip_smoke.py (its LIBRARY_FAMILIES, library_icdf
    and sass_counts), whichever package ``--root`` imports."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resources(cuobjdump, library):
    """Registers and stack and local bytes (``cuobjdump -res-usage``)."""
    usage = subprocess.run([str(cuobjdump), "-res-usage", str(library)], capture_output=True,
                           text=True, check=True).stdout
    found = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", usage)
    keys = ("registers", "stack_bytes", "local_bytes")
    return dict(zip(keys, map(int, found.groups()))) if found else dict.fromkeys(keys)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--singles", action="store_true")
    parser.add_argument("--library", action="store_true")
    parser.add_argument("--caps", default="")
    parser.add_argument("--tables", action="store_true")
    parser.add_argument("--guides", default="")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; torch.cuda.is_available() is False.")
    import probabilit_tpu_torch
    from probabilit_tpu_torch import _build, config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import cuda_exec
    from probabilit_tpu_torch.models import benchmarks
    from probabilit_tpu_torch.models.distributions import Distribution

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"device": smi, "package": str(Path(probabilit_tpu_torch.__file__).parent)})
    config.set_device("cuda")
    torch.distributions.Distribution.set_default_validate_args(False)
    words = cuda_exec.seed_words(4)
    cuobjdump = _build.nvcc_path().parent / "cuobjdump"
    smoke = chip_smoke()

    graphs = {label: sink for label, (sink, _) in benchmarks.family_graphs().items()
              if label != "newton"}
    graphs["mixed_dag_20"] = benchmarks.mixed_dag_20()
    graphs["mixed_correlated_50"] = benchmarks.mixed_correlated_50()
    graphs["breach_count"] = benchmarks.breach_count()[0]
    graphs["portfolio_var"] = benchmarks.portfolio_var()[0]
    sweep = {name: (a, k) for name, a, k in benchmarks.FAMILY_SWEEP}
    singles = {}
    if args.singles or args.library:
        names = cuda_exec._CLOSED_FORM_FAMILIES if args.singles else smoke.LIBRARY_FAMILIES
        for name in names:
            a, k = smoke.LIBRARY_FAMILIES.get(name) or sweep.get(name) or SINGLE_ARGS[name]
            singles[name] = (Distribution(name, *a, **k), a, k)
    tables = {"large_table": lambda: benchmarks.large_table(),
              "table_risk": lambda: benchmarks.table_risk()[0],
              "table_risk_correlated": lambda: benchmarks.table_risk_correlated()[0]}
    if args.tables:
        graphs.update({label: build() for label, build in tables.items()})
    tapes = {}
    for label, sink in [*graphs.items(), *((f"single {n}", s[0]) for n, s in singles.items())]:
        plan = _compile.get_plan(sink)
        tapes[label] = (plan, cuda_exec.lowered(plan, [sink._id], "cuda"))
    variants = [item for item in args.guides.split(",") if item]
    if args.tables and variants and hasattr(cuda_exec, "GUIDE_SPREAD"):
        names = ("GUIDE_SPREAD", "GUIDE_WINDOW", "GUIDE_MIN_BOUNDARIES")
        default = {name: getattr(cuda_exec, name) for name in (*names, "GUIDE_MAX_CELLS")}
        for item in variants:
            values = [int(v) for v in item.split(":")]
            for name, value in zip(names, values + [0] * (len(names) - len(values))):
                setattr(cuda_exec, name, value or default[name])
            # Spread 0: no guide (at most one cell).
            cuda_exec.GUIDE_MAX_CELLS = default["GUIDE_MAX_CELLS"] if values[0] else 1
            for label, build in tables.items():
                sink = build()
                plan = _compile.get_plan(sink)
                tapes[f"{label}, guides {item}"] = (
                    plan, cuda_exec.lowered(plan, [sink._id], "cuda"))
        for name, value in default.items():
            setattr(cuda_exec, name, value)
    caps = [int(m) for m in args.caps.split(",") if m]
    texts = {label: tape.source for label, (_, tape) in tapes.items()}
    for m in caps:
        for label in list(graphs)[:4]:
            texts[f"{label}, cap {m}"] = tapes[label][1].source.replace(
                "__launch_bounds__(kThreads)", f"__launch_bounds__(kThreads, {m})")

    def build(text):
        return _build.build_generated("graph_megakernel", text, cuda_exec._HEADERS)[0]

    # Built for tools/torch_sass_compare.py alone: the kernels whose device
    # code a change of the closed forms must leave as it was.
    untimed = {"newton": benchmarks.family_graphs()["newton"][0],
               "large_table": benchmarks.large_table(), "table_risk": benchmarks.table_risk()[0],
               "table_risk_correlated": benchmarks.table_risk_correlated()[0]}
    untimed = {label: cuda_exec.lowered(_compile.get_plan(s), [s._id], "cuda").source
               for label, s in untimed.items()}
    with ThreadPoolExecutor(8) as pool:
        libraries = dict(zip(texts, pool.map(build, texts.values())))
        for label, library in zip(untimed, pool.map(build, untimed.values())):
            emit({"graph": label, "untimed": True, "library": library.name})
    emit({"graph": "corr_stats", "untimed": True, "library": _build.build("corr_stats")[0].name})

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

    def launcher(tape, text, ab):
        fn = cuda_exec._megakernel(text)
        out = torch.empty((tape.n_keep, N), dtype=torch.float32, device="cuda")
        flag = torch.zeros((1,), dtype=torch.int32, device="cuda")

        def launch():
            err = fn(tape.const_block, len(tape.consts), ab.data_ptr() if tape.n_corr else None,
                     tape.n_corr, tape.tables.data_ptr() if tape.tables.numel() else None,
                     tape.tables.numel(), tape.n_keep, words[0], words[1], 0, N,
                     out.data_ptr(), flag.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return launch, out, flag

    for label, text in texts.items():
        plan, tape = tapes[label.split(", cap ")[0]]
        record_tape = {"shared_bytes": tape.shared_bytes,
                       "guides": [guide[2:] for guide in getattr(tape, "guides", ())]}
        ab = (cuda_exec.recolor_transform(plan, words, N, "cuda").float().contiguous()
              if tape.n_corr else None)
        launch, out, flag = launcher(tape, text, ab)
        record = {"graph": label, "library": libraries[label].name, "card": smi, "n": N,
                  "k1_ms": events_ms(launch),
                  "nonfinite": int(flag.item()), **record_tape,
                  **resources(cuobjdump, libraries[label]),
                  **smoke.sass_counts(_build, libraries[label])}
        name = label[len("single "):] if label.startswith("single ") else None
        if name in smoke.LIBRARY_FAMILIES and args.library:
            icdf, library = smoke.library_icdf(torch, name, *singles[name][1:])
            u = cuda_exec.philox_uniforms(words, N, 1, device="cuda")[:, 0]
            record["library_ms"] = events_ms(lambda: icdf(u))
            record["library_call"] = f"torch.distributions.{library}.icdf"
            record["library_max_abs_diff"] = (icdf(u) - out[0]).abs().max().item()
            record["k1_max_abs"] = out[0].abs().max().item()
            del u
        del out
        emit(record)


if __name__ == "__main__":
    main()
