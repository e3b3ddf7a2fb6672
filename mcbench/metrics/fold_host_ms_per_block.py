"""Host time of a streamed block's fold (``probabilit.fold`` spans: the
block moments, the quantile and histogram accumulators, the merge), per
block, ms."""

from mcbench import spans


def read(run):
    folds = spans.named(run, "probabilit.fold")
    if not run.cell.streamed or not folds:
        return None
    return sum(e - s for _, s, e in folds) / spans.blocks(run) / 1e6
