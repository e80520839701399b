"""The whole IF-AB2 step's share of the chip: the least time one step's
counted work allows (counts/spectral3d_step.py; the peak of the cell's
GEMM precision or HBM bandwidth, whichever binds) over the traced
window's time per step (jobs whole: init and diagnostics included)."""

from port_bench.counts import peaks, spectral3d_step

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "cell_updates_per_s"


def read(ctx):
    if not ctx.steps or not ctx.trace.device:
        return None
    c = ctx.cell.config
    flops, nbytes = spectral3d_step.count(c["nx"], c["ny"], c["nz"])
    least, _ = peaks.least_seconds(
        flops, nbytes, peaks.BY_PRECISION[ctx.route["matmul_precision"]])
    return 100.0 * least / (ctx.trace.seconds / ctx.steps)
