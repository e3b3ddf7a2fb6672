"""Compare the device code of the generated kernels two checkouts built.

    python3 tools/torch_sass_compare.py ROOT_A ROOT_B

For each checkout, dumps the SASS of every
``build/probabilit_tpu_torch/graph_megakernel-*.so`` and
``corr_stats-*.so`` it holds (what its runs built) with ``cuobjdump
-sass``, drops the addresses and encodings, and hashes each library's
instructions.  Prints one JSON object per
checkout ({library: [hash, instructions]}) and one with the hashes both
share and those only one has: two checkouts whose generated text differs
only in host code build the same device code.  Needs the CUDA toolkit
(``cuobjdump`` beside ``nvcc``); run it after both checkouts' kernels
were built (e.g. after ``tools/torch_path_timings.py --root``).
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def device_code(cuobjdump, library):
    """(hash, instruction count) of a library's SASS, addresses dropped."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    body = [re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
            for line in sass.splitlines() if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
    return hashlib.sha256("\n".join(body).encode()).hexdigest()[:16], len(body)


def main():
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    from probabilit_tpu_torch import _build

    cuobjdump = _build.nvcc_path().parent / "cuobjdump"
    found = {}
    for root in sys.argv[1:]:
        built = Path(root, "build", "probabilit_tpu_torch")
        libraries = sorted([*built.glob("graph_megakernel-*.so"), *built.glob("corr_stats-*.so")])
        found[root] = {lib.name: device_code(cuobjdump, lib) for lib in libraries}
        print(json.dumps({"root": root, "libraries": found[root]}), flush=True)
    a, b = ({tuple(v) for v in found[root].values()} for root in sys.argv[1:])
    print(json.dumps({"same_device_code": sorted(a & b), "only_first": sorted(a - b),
                      "only_second": sorted(b - a)}), flush=True)


if __name__ == "__main__":
    main()
