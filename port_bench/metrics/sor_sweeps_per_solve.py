"""Sweeps a member-solve of the SOR pressure solves (K1, K4, K5), from
the program's counters (`ns_tpu_torch.ops.kernels.sweep_counts`): every
solve since the harness's `reset_launch_counts()`, so the set-up warm-up
job, the traced warm-up job and the traced jobs. Each solve stops at its
gate (tol) or at its cap (nit - 1 sweeps for K1; groups of k up to nit
for K4 and K5). None where the program has no such counter or no SOR
solve ran."""

LAYER = "kernels"
UNIT = "sweeps/solve"
SOURCE = "program_counter"
MOVES = "cell_updates_per_s"


def read(ctx):
    from ns_tpu_torch.ops import kernels

    counts = getattr(kernels, "sweep_counts", None)
    if counts is None or not ctx.steps:
        return None
    pairs = counts().values()
    solves = sum(n for _, n in pairs)
    if not solves:
        return None
    return sum(s for s, _ in pairs) / solves
