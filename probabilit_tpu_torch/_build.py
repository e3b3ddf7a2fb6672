"""Build the package's CUDA sources with nvcc at first use, and load them.

Each ``csrc/<name>.cu`` becomes ``build/probabilit_tpu_torch/<name>-<key>.so``
beside the package, where ``<key>`` hashes the compiler flags and the
sources of ``csrc/``.  A generated source (the graph megakernel that
``engine/cuda_exec.py::generate`` writes per graph structure) is written
to ``<name>-<key>.cu`` in the same directory and built the same way, with
``csrc/`` on the include path; its ``<key>`` hashes the flags, the text
and the headers the text includes.  A build writes to a temporary file
and renames it into place, so a concurrent process never loads a
half-written library.  The libraries expose plain ``extern "C"`` entry
points, loaded with ``ctypes``.  A host source (``csrc/<name>.cpp``, the
Sobol direction-number search) is built the same way with the host C++
compiler (``build_host``, ``load_host``), its key hashing the flags and
the source.  Every failure raises: there is no fallback.  Deleting
``build/probabilit_tpu_torch/`` clears every build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "build",
    "load",
    "build_generated",
    "load_generated",
    "generated_key",
    "nvcc_path",
    "build_host",
    "load_host",
]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "probabilit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

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


def _compile(source, out, compiler=None, label="nvcc"):
    """nvcc (or ``compiler``, a command and its flags, named ``label`` in
    errors) ``source`` into the library ``out`` unless it exists; returns
    the compiler's output (``-Xptxas=-v`` register and spill counts),
    empty when the library was already built."""
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    if compiler is None:
        compiler = [str(nvcc_path()), *NVCC_FLAGS, "-I", str(CSRC)]
    cmd = [*compiler, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{label} failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout + proc.stderr


def build(name):
    """Compile ``csrc/<name>.cu`` unless the current build exists.

    Returns ``(path, log)``: the library's path and the compiler's output,
    empty when the library was already built.
    """
    out = BUILD_DIR / f"{name}-{_key()}.so"
    return out, _compile(CSRC / f"{name}.cu", out)


def generated_key(text, headers):
    """The cache key of a generated source: the compiler flags, the text
    and the bytes of the ``csrc/`` headers it includes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(text.encode())
    for header in headers:
        digest.update(header.encode())
        digest.update((CSRC / header).read_bytes())
    return digest.hexdigest()[:16]


def build_generated(name, text, headers):
    """Write the generated CUDA ``text`` beside its library and compile it
    unless that build exists.

    Returns ``(path, log)`` as ``build`` does.
    """
    stem = BUILD_DIR / f"{name}-{generated_key(text, headers)}"
    out, source = stem.with_suffix(".so"), stem.with_suffix(".cu")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = source.with_name(f"{source.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            tmp.write_text(text)
            os.replace(tmp, source)
        finally:
            tmp.unlink(missing_ok=True)
    return out, _compile(source, out)


def cxx_path():
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("no host C++ compiler found (set CXX or put g++ on PATH).")
    return found


def build_host(name):
    """Compile the host source ``csrc/<name>.cpp`` with the host C++
    compiler unless the current build exists; returns ``(path, log)`` as
    ``build`` does.  Its key hashes the flags and the source."""
    source = CSRC / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(source.read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    compiler = cxx_path()
    return out, _compile(source, out, [compiler, *CXX_FLAGS], Path(compiler).name)


def load_host(name):
    """The ``ctypes`` handle of ``csrc/<name>.cpp``, built at first use."""
    return _load(("host", name), lambda: build_host(name))


def _load(key, build_library):
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = _LIBS[key] = ctypes.CDLL(str(build_library()[0]))
        return lib


def load(name):
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built at first use."""
    return _load(name, lambda: build(name))


def load_generated(name, text, headers):
    """The ``ctypes`` handle of a generated source, built at first use and
    loaded once per process and key."""
    return _load(
        (name, generated_key(text, headers)), lambda: build_generated(name, text, headers)
    )
