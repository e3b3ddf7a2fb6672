"""The port's own spans in a traced run's timeline.

While a ``torch.profiler`` session records, the port opens a host span at
each of its layer boundaries, named ``probabilit.<layer>``
(``probabilit_tpu_torch/utils/profiling.py``); the timeline keeps them
among its host operations, on the clock of the device's operations.  Each
call's spans nest in its entry span (``probabilit.estimate`` or
``probabilit.sample``); a span belongs to the traced call whose interval
holds its start.  A program that opens no spans gives ``None`` here, and
the readers of its spans read nothing.
"""

from __future__ import annotations

import bisect

PREFIX = "probabilit."
ENTRIES = ("probabilit.estimate", "probabilit.sample")
LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel")


def of_calls(timeline):
    """Per traced call, its program spans as (name, start_ns, end_ns) in
    order of start; ``None`` where the trace holds no entry span."""
    spans = [op for op in timeline.host_ops if op[0].startswith(PREFIX)]
    if not any(op[0] in ENTRIES for op in spans):
        return None
    starts = [op[1] for op in spans]
    return [spans[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)]
            for s, e in timeline.calls]


def named(run, name):
    """Every ``name`` span of the traced calls, in order of start; ``None``
    where the trace holds no entry span."""
    calls = of_calls(run.timeline)
    if calls is None:
        return None
    return [span for spans in calls for span in spans if span[0] == name]


def blocks(run):
    """The blocks of the traced calls (a one-shot call is one block)."""
    return len(run.timeline.calls) * run.cell.blocks_per_call


def entry_self_ns(spans):
    """The self time of the outermost entry spans among one call's
    ``spans``: each one's duration less the time the spans nested in it
    cover."""
    total, outer_end = 0, None
    for i, (name, lo, hi) in enumerate(spans):
        if name not in ENTRIES or (outer_end is not None and lo < outer_end):
            continue
        outer_end, covered, reach = hi, 0, lo
        for _, s, e in spans[i + 1:]:
            if s >= hi:
                break
            s, e = max(s, reach), min(e, hi)
            if e > s:
                covered += e - s
                reach = e
        total += (hi - lo) - covered
    return total


def launches_in(timeline, spans):
    """The kernel launches the host issued inside ``spans``."""
    starts = [op[1] for op in timeline.host_ops if op[0].startswith(LAUNCH_EVENTS)]
    return sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
               for _, s, e in spans)
