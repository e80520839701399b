"""The device's idle share of the traced window: 1 - the union of its
records' intervals over the window's length."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "cell_updates_per_s"


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / (ctx.trace.t1 - ctx.trace.t0))
