"""The self time of a call's entry span (``probabilit.estimate`` or
``probabilit.sample``): its duration less the time the program's spans
nested in it cover, mean over the traced calls, ms (entry point and
streaming driver: argument checks, planning lookups, the block loop)."""

from mcbench import spans


def read(run):
    calls = spans.of_calls(run.timeline)
    if calls is None:
        return None
    return sum(spans.entry_self_ns(c) for c in calls) / len(calls) / 1e6
