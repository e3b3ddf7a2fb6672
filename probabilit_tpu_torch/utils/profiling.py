"""Tracing / profiling utilities, in PyTorch.

Port of ``probabilit_tpu/utils/profiling.py``:

* :func:`trace`: a context manager on ``torch.profiler`` that writes a
  Chrome-format trace (TensorBoard and Perfetto load it) under ``logdir``;
* :class:`PhaseTimer`: named wall-clock phases with a report.  With
  ``PROBABILIT_TPU_PROFILE=1``, ``sample()`` times its build+compile,
  execute and host phases on either executor and prints the report to
  stderr (``engine/sampler.py``);
* :func:`compiled_stats`: the flops, bytes, peak memory and output bytes
  of one call, counted op by op (PyTorch has no XLA cost analysis).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "PhaseTimer", "compiled_stats", "profiling_enabled"]


def profiling_enabled():
    return os.environ.get("PROBABILIT_TPU_PROFILE", "0") == "1"


@contextlib.contextmanager
def trace(logdir="probabilit_tpu_trace"):
    """Record CPU activity, and the card's when one is present, and write
    it as ``trace.json`` under ``logdir`` on exit.  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseTimer:
    """Named wall-clock phases: ``with timer.phase("execute", device): ...``.

    A phase given a CUDA ``device`` ends with ``torch.cuda.synchronize``
    of it, so its time covers the card's work and not only the launches
    (kernels run asynchronously, as a jitted JAX call does; there the host
    phase's ``device_get`` absorbs the wait).
    """

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name, device=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self):
        width = max((len(k) for k in self.phases), default=0)
        return "\n".join(
            f"{name:<{width}}  {seconds * 1e3:10.2f} ms"
            for name, seconds in self.phases.items()
        )


def _nbytes(t):
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot", "vdot"}


def _op_flops(func, args, out):
    """A matrix product's ``2mnk`` (``mm``, ``bmm``, ``addmm``, ...: an
    ``m x k`` by ``k x n`` product, batched), else one flop per output
    element, as XLA's ``HloCostAnalysis`` counts an elementwise op."""
    name = func.overloadpacket.__name__
    outs = list(_tensors(out))
    if name in _MATMULS:
        mats = [a for a in args if isinstance(a, torch.Tensor) and a.ndim >= 1]
        k = mats[-2].shape[-1]  # the left operand's inner dimension
        return 2 * k * sum(o.numel() for o in outs)
    return sum(o.numel() for o in outs)


def compiled_stats(fn, *example_args):
    """The cost of one call ``fn(*example_args)``: ``flops``,
    ``bytes_accessed``, ``peak_bytes`` and ``output_bytes``, the keys of
    the JAX package's XLA cost analysis.

    Every op the call dispatches is counted (a ``TorchDispatchMode``): a
    matrix product ``2mnk`` flops, any other op one flop per output
    element, a view nothing; ``bytes_accessed`` is each op's tensor
    inputs read plus its outputs written.  ``peak_bytes`` is ``torch.cuda.max_memory_allocated``
    over the call after a reset, on a CUDA device; it is None on the CPU,
    which keeps no such counter.  ``output_bytes`` is the bytes of what
    ``fn`` returns.
    """
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"flops": 0, "bytes_accessed": 0}

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.is_view:
                return out  # a view moves no bytes and computes nothing
            counts["flops"] += _op_flops(func, args, out)
            counts["bytes_accessed"] += sum(
                _nbytes(t) for t in _tensors((list(args), kwargs, out))
            )
            return out

    from probabilit_tpu_torch import config

    devices = {t.device for t in _tensors(list(example_args))} or {config.device()}
    cuda = next((d for d in devices if d.type == "cuda"), None)
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
    with _Count():
        out = fn(*example_args)
    peak = None
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        peak = int(torch.cuda.max_memory_allocated(cuda))
    return {
        "flops": int(counts["flops"]),
        "bytes_accessed": int(counts["bytes_accessed"]),
        "peak_bytes": peak,
        "output_bytes": int(sum(_nbytes(t) for t in _tensors(out))),
    }
