"""Device time of every operation that is neither K1, nor K2, nor a sort,
per streamed block, ms (the fold: block moments, merges, accumulators)."""


def read(run):
    if not run.cell.streamed:
        return None
    blocks = len(run.timeline.calls) * run.cell.blocks_per_call
    return run.timeline.group_ns("other") / blocks / 1e6
