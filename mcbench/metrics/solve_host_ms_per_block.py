"""Host time of the recolour solve after the statistics kernel
(``probabilit.solve`` spans: the target factor, the K x K solve, the
transform on the device), per block, ms."""

from mcbench import spans


def read(run):
    solves = spans.named(run, "probabilit.solve")
    if not solves:
        return None
    return sum(e - s for _, s, e in solves) / spans.blocks(run) / 1e6
