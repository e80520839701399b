"""K3 (`momentum_kernel`) against its roofline: the least time its
function allows (counts/momentum_explicit.py; fp32 CUDA-core peak or HBM
bandwidth, whichever binds) over its device time per call."""

from port_bench.counts import momentum_explicit, peaks

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "cell_updates_per_s"


def read(ctx):
    ks = [k for k in ctx.trace.kernels() if "momentum_kernel" in k[0]]
    if not ks:
        return None
    t = ctx.cell.traffic
    flops, nbytes = momentum_explicit.count(t["n"], t["n"],
                                            t.get("members") or 1)
    least, _ = peaks.least_seconds(flops, nbytes, "fp32")
    return 100.0 * least / (sum(k[2] for k in ks) * 1e-6 / len(ks))
