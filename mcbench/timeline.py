"""The device's timeline from a ``torch.profiler`` trace.

A traced run marks each call with a ``record_function`` span named
``CALL_SPAN``.  From the profiler's events this keeps the device's
operations (kernels, copies, sets), the host's operations, and the calls,
all on the profiler's one clock in nanoseconds.  The window runs from the
first call's start to the last call's end.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

CALL_SPAN = "mcbench.call"
GROUPS = json.loads((Path(__file__).resolve().parent / "metrics" / "kernel_groups.json").read_text())


def group_of(name):
    """The kernel group of a device operation's name (``kernel_groups.json``:
    case-insensitive substrings, the first group that matches), else
    ``"other"``."""
    low = name.lower()
    for group, keys in GROUPS.items():
        if any(key in low for key in keys):
            return group
    return "other"


class Timeline:
    def __init__(self, device_ops, host_ops, calls):
        """``device_ops`` and ``host_ops``: (name, start_ns, end_ns);
        ``calls``: (start_ns, end_ns), in order."""
        self.calls = sorted(calls)
        self.lo, self.hi = self.calls[0][0], self.calls[-1][1]
        self.device_ops = sorted(op for op in device_ops if op[2] > self.lo and op[1] < self.hi)
        self.host_ops = sorted(host_ops, key=lambda op: op[1])
        self.busy = self._merge([(max(s, self.lo), min(e, self.hi)) for _, s, e in self.device_ops])
        self._busy_starts = [s for s, _ in self.busy]

    @staticmethod
    def _merge(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def window_ns(self):
        return self.hi - self.lo

    def busy_ns(self, lo=None, hi=None):
        """Nanoseconds within [lo, hi] in which a device operation ran."""
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        total = 0
        for j in range(max(bisect.bisect_right(self._busy_starts, lo) - 1, 0), len(self.busy)):
            s, e = self.busy[j]
            if s >= hi:
                break
            total += max(0, min(e, hi) - max(s, lo))
        return total

    def ops_in(self, group):
        """The device operations of a kernel group, within the window."""
        return [op for op in self.device_ops if group_of(op[0]) == group]

    def group_ns(self, group):
        return sum(min(e, self.hi) - max(s, self.lo) for _, s, e in self.ops_in(group))

    def names_by_group(self):
        """{group: {device operation name: count}} within the window."""
        out = {}
        for name, _, _ in self.device_ops:
            names = out.setdefault(group_of(name), {})
            names[name[:200]] = names.get(name[:200], 0) + 1
        return out

    def gaps(self):
        """Idle stretches of the window: (start_ns, end_ns)."""
        edges = [self.lo] + [x for s, e in self.busy for x in (s, e)] + [self.hi]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def host_segments(self):
        """The host's timeline flattened: (start_ns, end_ns, name of the
        innermost host operation running), in order; time outside every
        operation is left out."""
        if hasattr(self, "_segments"):
            return self._segments
        segments, stack, cur = [], [], None

        def close_until(t):
            nonlocal cur
            while stack and stack[-1][0] <= t:
                end, name = stack.pop()
                if end > cur:
                    segments.append((cur, end, name))
                    cur = end

        for name, s, e in sorted(self.host_ops, key=lambda op: (op[1], -op[2])):
            close_until(s)
            if stack and s > cur:
                segments.append((cur, s, stack[-1][1]))
            cur = s if cur is None else max(cur, s)
            stack.append((e, name))
        close_until(float("inf"))
        self._segments = segments
        self._segment_starts = [s for s, _, _ in segments]
        return segments

    def host_during(self, a, b):
        """{innermost host operation: ns} over [a, b]; the rest ``"python"``."""
        segments = self.host_segments()
        out, covered = {}, 0
        for j in range(max(bisect.bisect_right(self._segment_starts, a) - 1, 0), len(segments)):
            s, e, name = segments[j]
            if s >= b:
                break
            overlap = min(e, b) - max(s, a)
            if overlap > 0:
                out[name] = out.get(name, 0) + overlap
                covered += overlap
        if b - a > covered:
            out["python"] = out.get("python", 0) + (b - a - covered)
        return out

    def breakdown(self, top=10):
        """The device operations that took most time and the idle time by
        what the host was doing, seconds, at most ``top`` of each."""
        by_name = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0) + min(e, self.hi) - max(s, self.lo)
        idle = {}
        for a, b in self.gaps():
            for name, ns in self.host_during(a, b).items():
                idle[name] = idle.get(name, 0) + ns

        def ranked(d):
            return [[name[:200], ns / 1e9] for name, ns in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_name), "idle_gaps": ranked(idle)}


def from_profiler(prof):
    """A ``Timeline`` from a stopped ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops, calls = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == cuda:
            if getattr(e, "is_user_annotation", lambda: False)() or name == CALL_SPAN:
                continue
            device_ops.append((name, s, end))
        elif name == CALL_SPAN:
            calls.append((s, end))
        else:
            host_ops.append((name, s, end))
    if not calls:
        raise RuntimeError("the trace holds no call span")
    return Timeline(device_ops, host_ops, calls)
