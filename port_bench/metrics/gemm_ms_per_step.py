"""Device time of the GEMM layer's library kernels (cuBLAS and CUTLASS,
matched by name) per solver step: the x-stage DFT GEMMs, and on the plain
route every transform stage."""

import re

LAYER = "GEMM layer"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "cell_updates_per_s"
GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass", re.IGNORECASE)


def read(ctx):
    ks = [k for k in ctx.trace.kernels() if GEMM.search(k[0])]
    if not ks or not ctx.steps:
        return None
    return sum(k[2] for k in ks) * 1e-3 / ctx.steps
