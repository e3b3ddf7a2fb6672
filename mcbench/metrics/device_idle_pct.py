"""The share of the traced window in which no device operation ran, %."""


def read(run):
    t = run.timeline
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns)
