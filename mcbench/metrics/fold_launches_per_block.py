"""Kernel launches the host issues inside a streamed block's fold
(``cudaLaunchKernel``/``cuLaunchKernel`` runtime events within
``probabilit.fold`` spans), per block."""

from mcbench import spans


def read(run):
    folds = spans.named(run, "probabilit.fold")
    if not run.cell.streamed or not folds:
        return None
    return spans.launches_in(run.timeline, folds) / spans.blocks(run)
