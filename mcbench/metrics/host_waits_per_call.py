"""The points at which a call's host waits for the device
(``probabilit.wait`` spans), per traced call (entry point and streaming
driver)."""

from mcbench import spans


def read(run):
    waits = spans.named(run, "probabilit.wait")
    if waits is None:
        return None
    return len(waits) / len(run.timeline.calls)
