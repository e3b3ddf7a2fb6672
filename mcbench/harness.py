"""One run of one cell: set-up, the measured window, the output check.

``run_cell`` builds the configuration's graph with the port's public node
classes, warms the cell's one shape up with one call (planning, the
nearest-correlation repair, loading or building K1 and K2), and then
calls the traffic mix's entry in a closed loop for ``seconds``, each call
with its own ``random_state`` from the run's seed.  Every call must move
the port's launch counters that the mix names by as much as its path
does (K1 and, in a correlated graph, K2 once a block).  A call that takes
another path stops the run.

With ``trace`` the window runs under ``torch.profiler`` for at most
``TRACE_MAX_CALLS`` calls or ``TRACE_MAX_SECONDS``, and the per-layer
metrics are read from its timeline by the readers in ``metrics/``.

After the window, and after the device's peak memory is read, a sample of
the finished calls drawn from the seed is recomputed by the plain
reference (``reference.py``) on the same device and compared
(``compare.py``) against the limits in ``limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import importlib
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from mcbench import compare, reference, spec, timeline, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "probabilit_tpu")
TRACE_MAX_CALLS = 48
TRACE_MAX_SECONDS = 6.0


class WrongPath(RuntimeError):
    """A call that did not launch the kernels its path launches."""


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class _Reservoir:
    """A uniform sample of ``k`` of the finished calls, drawn from ``rng``
    without knowing how many will finish (Vitter's algorithm R)."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _launch_counter(names):
    """``read()``: the port's launch counters ``names`` (``module.NAME``
    under ``probabilit_tpu_torch``), as a tuple."""
    where = [name.rpartition(".") for name in names]
    modules = [importlib.import_module(f"probabilit_tpu_torch.{m}") for m, _, _ in where]
    return lambda: tuple(getattr(mod, attr) for mod, (_, _, attr) in zip(modules, where))


def run_cell(cell, seed, seconds, trace, t0, device="cuda", check_launches=True):
    """One run; returns (result dict, [earlier lines], [check lines])."""
    from probabilit_tpu_torch import config as port_config

    marks = {"imported": time.perf_counter() - t0}
    port_config.set_device(device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
    marks["context"] = time.perf_counter() - t0
    sink = spec.build_graph(cell.config)
    call = spec.caller(sink, cell.traffic)
    path = cell.launches()
    launches = _launch_counter(list(path))
    expected = tuple(path.values())

    def one(s):
        before = launches()
        out = call(s)
        made = tuple(a - b for a, b in zip(launches(), before))
        if check_launches and made != expected:
            raise WrongPath(f"a call launched {dict(zip(path, made))}, its path {path}")
        return out

    warm = one(spec.call_seed(seed, 1, 0))  # warm-up: the cell's one shape
    marks["first_call"] = time.perf_counter() - t0
    if isinstance(warm, torch.Tensor):
        # Room in the allocator's pool for the answers the check keeps, so
        # that keeping one allocates nothing in the window.
        spare = [torch.empty_like(warm) for _ in range(int(cell.traffic["check_calls"]) + 1)]
        del spare
    del warm
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    kept = _Reservoir(int(cell.traffic["check_calls"]), np.random.default_rng([int(seed) % 2**64, 2]))
    times, attempted, failed = [], 0, 0
    limit_s = min(seconds, TRACE_MAX_SECONDS) if trace else seconds
    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    start = time.perf_counter()
    i = 0
    while True:
        s = spec.call_seed(seed, 0, i)
        attempted += 1
        span = torch.profiler.record_function(timeline.CALL_SPAN) if trace else contextlib.nullcontext()
        t = time.perf_counter()
        try:
            with span:
                out = one(s)
        except WrongPath:
            raise
        except Exception:  # a call that fails counts, and the run goes on
            failed += 1
            traceback.print_exc(file=sys.stderr)
            out = None
        now = time.perf_counter()
        if out is not None:
            times.append(now - t)
            kept.offer((i, s, out))
        i += 1
        if now - start >= limit_s or (trace and i >= TRACE_MAX_CALLS):
            break
    window_s = now - start
    if on_card:
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    earlier = [{"setup_marks_s": marks}]
    metrics, breakdown = {}, None
    if not times:
        raise RuntimeError("no call finished in the window")
    if trace:
        line = timeline.from_profiler(prof)
        del prof
        if not line.device_ops:
            raise RuntimeError("the traced window recorded no device operation")
        run = SimpleNamespace(cell=cell, timeline=line)
        for m in cell.metrics("per_layer"):
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy_s, traced_s = line.busy_ns() / 1e9, line.window_ns / 1e9
        breakdown = line.breakdown()
        earlier.append({"traced_calls": len(line.calls), "device_ops": len(line.device_ops),
                        "busy_s": busy_s, "window_s": traced_s,
                        "kernel_names": line.names_by_group()})
        earlier.append({"card": _card(), "bounds_s": _bounds(cell)})
    else:
        values = {
            "samples_per_s": len(times) * cell.size / window_s,
            "call_p95_ms": float(np.percentile(times, 95)) * 1e3,
            "setup_s": setup_s,
        }
        for m in cell.metrics("end_to_end"):
            # ``<quantity>.<qualifier>`` reports the quantity under its own bound.
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
        earlier.append({"calls": len(times), "window_s": window_s,
                        "call_p50_ms": float(np.percentile(times, 50)) * 1e3})

    # The output check, once the program's own work is done.
    del sink, call, one
    t = time.perf_counter()
    readings = [check(cell, s, out, device) for _, s, out in kept.items]
    kept.items.clear()
    numbers = compare.worst(readings)
    ok, rows = compare.judge(numbers, cell.limits)
    earlier.append({"checked_calls": len(readings), "of": len(times),
                    "check_s": time.perf_counter() - t})

    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    if trace:
        device_info.update(busy_s=busy_s, window_s=traced_s)
    out = {
        "correct": bool(ok and failed == 0 and readings),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    lines = [f"check {name} {v!r} limit {lim!r}" for name, v, lim in rows]
    return out, earlier, lines


def _card():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read: {exc}"
    return out.stdout.strip()


def _bounds(cell):
    """Each kernel's bound per launch, seconds, and the term that binds it."""
    k1 = yardstick.k1_bound(cell.config, cell.rows_per_launch)
    k2 = yardstick.k2_bound(cell.config, cell.rows_per_launch)
    out = {"k1": {"s": k1[0], "by": k1[1]}}
    if k2 is not None:
        out["k2"] = {"s": k2[0], "by": k2[1]}
    return out


def reference_answer(cell, s, device, arith="float64"):
    """The plain reference's answer to the cell's call with ``random_state`` ``s``."""
    return cell.answer().reference_answer(cell, s, device, arith)


def numbers(cell, answer, ref):
    """The numbers of one answer against the reference's."""
    return cell.answer().numbers(cell, answer, ref)


def check(cell, s, program_out, device):
    """The numbers of one finished call against the plain reference."""
    return numbers(cell, program_out, reference_answer(cell, s, device))
