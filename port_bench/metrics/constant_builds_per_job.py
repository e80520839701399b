"""Host-side constant builds (spectral3d's `spectral3d.constants` spans
that start in the traced window) per traced job: what each rollout job
rebuilds on the host. None where the program has no such span or the
window holds no job; 0 where the constants are built once."""

LAYER = "solver step loop"
UNIT = "builds/job"
SOURCE = "program_span"
MOVES = "cell_updates_per_s"


def read(ctx):
    from ns_tpu_torch.solvers import spectral3d

    name = getattr(spectral3d, "CONSTANTS_SPAN", None)
    if name is None or not ctx.steps:
        return None
    tr = ctx.trace
    builds = sum(1 for a, _, _ in tr.spans(name) if tr.t0 <= a < tr.t1)
    return builds / (ctx.steps / ctx.cell.traffic["nt_job"])
