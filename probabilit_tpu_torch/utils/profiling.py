"""Tracing / profiling utilities, in PyTorch.

Port of ``probabilit_tpu/utils/profiling.py``:

* :func:`trace`: a context manager on ``torch.profiler`` that writes a
  Chrome-format trace (TensorBoard and Perfetto load it) under ``logdir``;
* :class:`PhaseTimer`: named wall-clock phases with a report.  With
  ``PROBABILIT_TPU_PROFILE=1``, ``sample()`` times its build+compile,
  execute and host phases on either executor and prints the report to
  stderr (``engine/sampler.py``);
* :func:`compiled_stats`: the flops, bytes, peak memory and output bytes
  of one call, counted op by op (PyTorch has no XLA cost analysis);
* :func:`span`: a named host span at one of the port's layer boundaries,
  recorded while a ``torch.profiler`` session records and free otherwise.

The port opens these spans, each named ``probabilit.<layer>``:

* ``probabilit.estimate`` and ``probabilit.sample``: a whole call of the
  streamed ``estimate`` or of ``sample`` (either executor); every other
  span of the call nests in it;
* ``probabilit.k1``: ``cuda_exec.run``, the checks, allocations and launch
  of the sampling kernel (the plain twin on a CPU tape);
* ``probabilit.k2``: ``cuda_exec.corr_stats``, the statistics kernel's
  checks, grid, launch and the sum of its partials;
* ``probabilit.solve``: the recolour solve after the statistics: the
  target factor, the host or device solve, the transform's copy to the
  device;
* ``probabilit.fold``: a streamed block's fold into the estimate's carry
  (moments, quantile and histogram accumulators, the merge);
* ``probabilit.wait``: a point where the host waits for the device: the
  non-finite flag of ``sample`` (either executor), the statistics' copy
  of a host solve, the read of an estimate's carry;
* ``probabilit.plan`` and ``probabilit.build``: a plan built on a cache
  miss (with the nearest-correlation repair), and a kernel library built
  or loaded at first use.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "PhaseTimer", "compiled_stats", "profiling_enabled", "span"]


def profiling_enabled():
    return os.environ.get("PROBABILIT_TPU_PROFILE", "0") == "1"


_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A context manager that records ``name`` as a host span while a
    ``torch.profiler`` session records (``trace``, or any other), on the
    clock of the device's operations in the same trace; with no session
    it is one shared no-op, which costs one check a span.

    A span is a ``_RecordFunctionFast``: on an H100 machine's host it costs
    about 2 us while the profiler records, against about 14 us for
    ``torch.profiler.record_function``, and it puts no user annotation on
    the device's timeline."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


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
