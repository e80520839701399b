"""Device records (kernels, copies, memsets) in the traced window per
solver step: the host's dispatch count that capturing the loop in a graph
would remove. Init and diagnostics records count, as a job pays them."""

LAYER = "solver step loop"
UNIT = "launches/step"
SOURCE = "device_trace"
MOVES = "cell_updates_per_s"


def read(ctx):
    if not ctx.steps or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.steps
