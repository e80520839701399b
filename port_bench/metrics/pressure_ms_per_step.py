"""Device time of the kernels launched inside chorin_fd's
`chorin_fd.pressure` span, per solver step: the SOR solve (K1 batched,
K4 at 1024^2), its rhs and the p BCs."""

LAYER = "solver step loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "cell_updates_per_s"


def read(ctx):
    ks = ctx.trace.launched_in("chorin_fd.pressure")
    if not ks or not ctx.steps:
        return None
    return sum(k[2] for k in ks) * 1e-3 / ctx.steps
