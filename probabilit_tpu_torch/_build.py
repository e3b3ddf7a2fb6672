"""Build the package's CUDA sources with nvcc at first use, and load them.

Each ``csrc/<name>.cu`` becomes ``build/probabilit_tpu_torch/<name>-<key>.so``
beside the package, where ``<key>`` hashes the compiler flags and the
sources of ``csrc/``.  A build writes to a temporary file and renames it
into place, so a concurrent process never loads a half-written library.
The libraries expose plain ``extern "C"`` entry points, loaded with
``ctypes``.  Every failure raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "probabilit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH).")


def _key():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build(name):
    """Compile ``csrc/<name>.cu`` unless the current build exists.

    Returns ``(path, log)``: the library's path and the compiler's output
    (``-Xptxas=-v`` register and spill counts), empty when the library was
    already built.
    """
    out = BUILD_DIR / f"{name}-{_key()}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [str(nvcc_path()), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out, proc.stdout + proc.stderr


def load(name):
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path, _ = build(name)
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
