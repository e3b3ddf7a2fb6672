"""One run of one cell of the port's benchmark.

    python3 mcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``probabilit_tpu_torch``, on a
machine with the CUDA cards the cell asks for.  Prints one JSON object a
line, the result last: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number of the output check beside its limit, which also
end standard error.  Without a card, without enough cards, without the
program in the checkout, on a call that takes another path than its
cell's, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)  # the checkout, not this folder


def main(argv=None):
    parser = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from mcbench import harness, spec

    cell = spec.Cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}.", file=sys.stderr)
        return 2
    import probabilit_tpu_torch

    if not Path(probabilit_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"probabilit_tpu_torch is not in this checkout ({probabilit_tpu_torch.__file__}).",
              file=sys.stderr)
        return 2
    result, earlier, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in earlier:
        print(json.dumps(line), flush=True)
    print(json.dumps(result), flush=True)
    print("\n".join(checks), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
