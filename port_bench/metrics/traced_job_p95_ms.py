"""The 95th percentile of the traced jobs' times, each from the start of
its `job.init` span to the end of its `job.diagnostics` span on the
profiler's host clock (the diagnostics end in the job's host read): the
job tail of a cell where the tail over the whole window spreads too
widely from run to run to be held end to end. Over the cell's
`trace_jobs` jobs, under the profiler."""

import statistics

LAYER = "solver step loop"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "cell_updates_per_s"


def read(ctx):
    starts = sorted(a for a, _, _ in ctx.trace.spans("job.init"))
    ends = sorted(b for _, b, _ in ctx.trace.spans("job.diagnostics"))
    if len(starts) < 2 or len(starts) != len(ends):
        return None
    times = [b - a for a, b in zip(starts, ends)]
    return statistics.quantiles(times, n=20, method="inclusive")[18] * 1e-3
