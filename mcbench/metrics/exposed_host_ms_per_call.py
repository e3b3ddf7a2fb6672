"""Host time a call leaves exposed: the call's wall time on the host's clock
minus the time inside it in which a device operation ran, mean over the
traced calls, ms (entry point and streaming driver)."""


def read(run):
    t = run.timeline
    exposed = [(e - s) - t.busy_ns(s, e) for s, e in t.calls]
    return sum(exposed) / len(exposed) / 1e6
