"""K2's share of its roofline: the least time for one launch's statistics
(``yardstick.k2_bound``: the draws and scores, and the cross products at
the tensor cores' rate) over K2's mean device time per launch, %."""

from mcbench import yardstick


def read(run):
    ops = run.timeline.ops_in("k2")
    if not ops or not run.cell.correlated:
        return None
    mean_s = sum(e - s for _, s, e in ops) / len(ops) / 1e9
    bound_s, _ = yardstick.k2_bound(run.cell.config, run.cell.rows_per_launch)
    return 100.0 * bound_s / mean_s
