"""K1's share of its roofline: the least time for one launch's samples
(``yardstick.k1_bound``, counted from the configuration's graph) over
K1's mean device time per launch, %."""

from mcbench import yardstick


def read(run):
    ops = run.timeline.ops_in("k1")
    if not ops:
        return None
    mean_s = sum(e - s for _, s, e in ops) / len(ops) / 1e9
    bound_s, _ = yardstick.k1_bound(run.cell.config, run.cell.rows_per_launch)
    return 100.0 * bound_s / mean_s
