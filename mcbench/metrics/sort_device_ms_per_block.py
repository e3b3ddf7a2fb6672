"""Device time of the sort kernels (the quantile rows' ``torch.sort``), per
streamed block, ms."""


def read(run):
    ns = run.timeline.group_ns("sort")
    if not run.cell.streamed or ns == 0:
        return None
    return ns / (len(run.timeline.calls) * run.cell.blocks_per_call) / 1e6
