"""The readings that the limits of a cell's output check are set from.

    python3 mcbench/calibrate.py --workload <name> --seeds 12 --controls 3 --stale 3 [--first 1000]

On the card, in one process: the cell's call (the timed path) on
``--seeds`` seeds, each against the plain reference (the lower readings);
the control, the reference computed in bfloat16, against the reference
on the first ``--controls`` of those seeds (the upper readings); and a
stale answer, the previous seed's answer in the place of this seed's, as
a call that returns its previous answer gives it, against the reference
on the next ``--stale`` seeds.  Prints one JSON object a line, and last,
per number, the largest program reading and the smallest control and
stale readings.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--stale", type=int, default=3)
    parser.add_argument("--first", type=int, default=1000, help="seed of the first run")
    args = parser.parse_args(argv)

    import torch

    from mcbench import harness, spec
    from probabilit_tpu_torch import config

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    config.set_device("cuda")
    cell = spec.Cell(args.workload, ROOT)
    call = spec.caller(spec.build_graph(cell.config), cell.traffic)
    program, control, stale, previous = [], [], [], None
    for j in range(args.seeds):
        run_seed = args.first + j
        s = spec.call_seed(run_seed, 0, 0)  # the first call of a run of this seed
        t = time.perf_counter()
        answer = call(s)
        prog_s = time.perf_counter() - t
        t = time.perf_counter()
        ref = harness.reference_answer(cell, s, "cuda")
        reading = harness.numbers(cell, answer, ref)
        row = {"seed": run_seed, "program": reading, "program_s": prog_s}
        if previous is not None and len(stale) < args.stale:
            row["stale"] = harness.numbers(cell, previous, ref)
            stale.append(row["stale"])
        previous = answer
        del answer
        if j < args.controls:
            low = harness.reference_answer(cell, s, "cuda", arith="bfloat16")
            row["control"] = harness.numbers(cell, low, ref)
            control.append(row["control"])
        row["reference_s"] = time.perf_counter() - t
        program.append(reading)
        print(json.dumps(row), flush=True)
    summary = {
        "workload": args.workload,
        "lower": {k: max(r[k] for r in program) for k in program[0]},
        "upper": {k: min(r[k] for r in control) for k in control[0]} if control else {},
        "stale": {k: min(r[k] for r in stale) for k in stale[0]} if stale else {},
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
