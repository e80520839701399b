"""K8 (`fused_lamb`: `lamb_phys_*` then `lamb_yfwd_*`) against its
roofline: the least time its function allows (counts/fused_lamb.py, the
peak of the cell's GEMM precision or HBM bandwidth, whichever binds) over
its device time per call."""

from port_bench.counts import fused_lamb, peaks
from port_bench.counts.spectral3d_step import kept

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "cell_updates_per_s"


def read(ctx):
    ks = ctx.trace.kernels()
    calls = sum(1 for k in ks if "lamb_phys" in k[0])
    if not calls:
        return None
    us = sum(k[2] for k in ks if "lamb_phys" in k[0] or "lamb_yfwd" in k[0])
    c = ctx.cell.config
    ry, kzc = kept(c["ny"], False), kept(c["nz"], True)
    flops, nbytes = fused_lamb.count(c["nx"], c["ny"], c["nz"], ry, kzc)
    least, _ = peaks.least_seconds(
        flops, nbytes, peaks.BY_PRECISION[ctx.route["matmul_precision"]])
    return 100.0 * least / (us * 1e-6 / calls)
