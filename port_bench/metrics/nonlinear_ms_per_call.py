"""Device time of the kernels launched inside spectral3d's
`spectral3d.nonlinear` span (the nonlinear term: the fused K8 leg or the
plain inverse, cross product and forward, the Leray projection), per
call of the span in the traced window (a job's steps and its AB2
self-start in init)."""

LAYER = "solver step loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "cell_updates_per_s"
SPAN = "spectral3d.nonlinear"


def read(ctx):
    tr = ctx.trace
    calls = sum(1 for a, _, _ in tr.spans(SPAN) if tr.t0 <= a < tr.t1)
    ks = tr.launched_in(SPAN)
    if not ks or not calls:
        return None
    return sum(k[2] for k in ks) * 1e-3 / calls
