"""Hand-written Hopper kernels of the port, with their wrappers and twins.

Each wrapper calls its operator in `torch.ops.ns_tpu` (`library.py`),
whose CUDA implementation launches the kernel and whose CPU
implementation runs the twin. Importing this package registers the
operators, builds nothing and needs no GPU: the library is compiled
(`_build.library`) at the first launch on a CUDA tensor.
"""

from ns_tpu_torch.ops.kernels.momentum_kernels import (
    momentum_explicit, momentum_explicit_fused)
from ns_tpu_torch.ops.kernels.poisson_kernels import (
    jacobi_fused, jacobi_multiblock, pack_redblack, reset_sweep_counts,
    smem_fits, sor_redblack_fused, sor_redblack_multiblock,
    sor_redblack_packed_multiblock, sor_redblack_packed_tiled,
    sor_redblack_tiled, sweep_counts, unpack_redblack)
from ns_tpu_torch.ops.kernels.transform3d_kernels import (
    fused_fits, fused_lamb, fused_yz_inverse, fused_zy_forward, lamb,
    yz_inverse, zy_forward)
from ns_tpu_torch.ops.kernels import library  # noqa: F401 (registers)

# every kernel wrapper of the port, by the TPU kernel id it replaces
WRAPPERS = {
    "K1": sor_redblack_fused,
    "K2": jacobi_fused,
    "K2mb": jacobi_multiblock,  # K2's multi-block form
    "K3": momentum_explicit_fused,
    "K4": sor_redblack_packed_multiblock,
    "K5": sor_redblack_multiblock,
    "K6": fused_zy_forward,
    "K7": fused_yz_inverse,
    "K8": fused_lamb,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by wrapper name."""
    return {w.__name__: w.launches for w in WRAPPERS.values()}


def call_counts() -> dict[str, int]:
    """Wrapper calls that launched since the last reset, by wrapper name
    (the group routes of K2mb, K4 and K5 launch once per group of a
    call)."""
    return {w.__name__: w.calls for w in WRAPPERS.values()}


def reset_launch_counts() -> None:
    """Zero the launch and call counters, and the SOR wrappers' sweep
    counts (`sweep_counts`: {wrapper: (sweeps, member-solves)})."""
    reset_sweep_counts()
    for w in WRAPPERS.values():
        w.launches = 0
        w.calls = 0
    for w in (jacobi_multiblock, sor_redblack_packed_multiblock,
              sor_redblack_multiblock):
        w.launches_resident = 0
    for w in (fused_zy_forward, fused_yz_inverse, fused_lamb):
        w.launches_bf16 = 0
        w.launches_tf32 = 0
