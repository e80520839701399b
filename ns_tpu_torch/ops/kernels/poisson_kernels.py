"""Pressure-solve kernels: wrappers of K1, K2, K5 (`csrc/poisson_kernels.cu`).

Each wrapper replaces a kernel of `ns_tpu/ops/pallas/poisson_kernels.py`
and keeps a plain twin:
  K2 `jacobi_fused`            <- `jacobi_fused_pallas`;
                                  twin `ops.poisson.jacobi` + `apply_bcs`
  K2 `jacobi_multiblock`       <- the same, beyond one block (the grids where
                                  the JAX package runs its XLA Jacobi); same
                                  twin
  K1 `sor_redblack_fused`      <- `sor_redblack_fused_pallas`;
                                  twin `ops.poisson.sor_redblack`
  K5 `sor_redblack_multiblock` <- `sor_redblack_tiled_pallas` and its
                                  entry `sor_redblack_tiled_any`;
                                  twin `sor_redblack_tiled` (here)

Dispatch is by the tensor's device: a CPU tensor takes the plain twin, a
CUDA tensor launches the kernel or raises; nothing falls back. Each wrapper
counts its kernel launches in a `launches` attribute.

What bounds each kernel on the H100, and how the design answers it, is in
the CUDA source's header. In short: K1/K2 keep the whole grid in one
block's shared memory and run every sweep (and K1's convergence gate) in
one launch, because at the reference sizes a solve is latency-bound; K5
runs each colour half-sweep over the whole grid with many blocks and reads
its gate once per k sweeps; K2's multi-block form runs each sweep as one
grid launch and the BC edges as one ordered single-block launch.
"""

from __future__ import annotations

import math

import torch

from ns_tpu_torch.core.bc import apply_bcs
from ns_tpu_torch.ops import poisson
from ns_tpu_torch.ops.kernels import _build

# Shared memory one Hopper block may opt into (227 KB), less 1 KB for the
# kernels' static reduction scratch.
SMEM_BUDGET = 227 * 1024 - 1024


def smem_fits(nx: int, ny: int, n_arrays: int = 2, itemsize: int = 4) -> bool:
    """True when `n_arrays` (nx, ny) grids of `itemsize` bytes fit one
    block's shared memory (the counterpart of the TPU kernels' vmem_fits).
    K1 holds p and rhs_c, K2 its ping-pong pair: two grids each."""
    return nx * ny * n_arrays * itemsize <= SMEM_BUDGET


def _consts(dx: float, dy: float):
    dx2, dy2 = dx * dx, dy * dy
    return dx2, dy2, 2.0 * (dx2 + dy2)


def jacobi_fused(p: torch.Tensor, b: torch.Tensor, dx: float, dy: float,
                 n_iter: int, p_bc) -> torch.Tensor:
    """All `n_iter` Jacobi sweeps, each followed by the p BC edge writes in
    list order (direct_fd's pressure), in one launch of one block (K2)."""
    if p.device.type == "cpu":
        return poisson.jacobi(p, b, dx, dy, n_iter,
                              bc_fn=lambda q: apply_bcs(q, p_bc))
    nx, ny = _build.check_inputs("jacobi_fused", p, b)
    if not smem_fits(nx, ny, 2, p.element_size()):
        raise ValueError(f"jacobi_fused: a {nx}x{ny} {p.dtype} grid does not "
                         "fit one block's shared memory")
    dx2, dy2, denom = _consts(dx, dy)
    out = torch.empty_like(p)
    spec = _build.bc_spec(p_bc)
    fn = _build.entry("ns_jacobi_fused", p.dtype)
    with torch.cuda.device(p.device):
        code = fn(p.data_ptr(), b.data_ptr(), out.data_ptr(), nx, ny,
                  int(n_iter), dx2, dy2, denom, dx2 * dy2 / denom, len(p_bc),
                  spec, _build.stream(p.device))
    _build.check(code, "jacobi_fused")
    jacobi_fused.launches += 1
    return out


jacobi_fused.launches = 0


def jacobi_multiblock(p: torch.Tensor, b: torch.Tensor, dx: float, dy: float,
                      n_iter: int, p_bc) -> torch.Tensor:
    """`jacobi_fused` for any grid size: each sweep is one grid launch into
    the other buffer of a device ping-pong pair, followed by one launch
    that writes the p BC edges in list order (K2, multi-block form). The
    whole solve is enqueued with no host sync."""
    if p.device.type == "cpu":
        return poisson.jacobi(p, b, dx, dy, n_iter,
                              bc_fn=lambda q: apply_bcs(q, p_bc))
    nx, ny = _build.check_inputs("jacobi_multiblock", p, b)
    dx2, dy2, denom = _consts(dx, dy)
    out, scratch = torch.empty_like(p), torch.empty_like(p)
    spec = _build.bc_spec(p_bc)
    fn = _build.entry("ns_jacobi_multiblock", p.dtype)
    with torch.cuda.device(p.device):
        code = fn(p.data_ptr(), b.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), nx, ny, int(n_iter), dx2, dy2, denom,
                  dx2 * dy2 / denom, len(p_bc), spec, _build.stream(p.device))
    _build.check(code, "jacobi_multiblock")
    jacobi_multiblock.launches += 1
    return out


jacobi_multiblock.launches = 0


def sor_redblack_fused(p: torch.Tensor, rhs_c: torch.Tensor, dx: float,
                       dy: float, beta: float, tol: float,
                       max_iter: int) -> torch.Tensor:
    """Red-black SOR to tolerance with the gate on the device: the whole
    chorin_fd pressure solve in one launch of one block (K1)."""
    if p.device.type == "cpu":
        return poisson.sor_redblack(p, rhs_c, dx, dy, beta, tol, max_iter)
    nx, ny = _build.check_inputs("sor_redblack_fused", p, rhs_c)
    if not smem_fits(nx, ny, 2, p.element_size()):
        raise ValueError(f"sor_redblack_fused: a {nx}x{ny} {p.dtype} grid "
                         "does not fit one block's shared memory; use "
                         "sor_redblack_multiblock")
    dx2, dy2, denom = _consts(dx, dy)
    out = torch.empty_like(p)
    fn = _build.entry("ns_sor_redblack_fused", p.dtype)
    with torch.cuda.device(p.device):
        code = fn(p.data_ptr(), rhs_c.data_ptr(), out.data_ptr(), nx, ny,
                  dx2, dy2, denom, float(beta), float(tol), int(max_iter),
                  _build.stream(p.device))
    _build.check(code, "sor_redblack_fused")
    sor_redblack_fused.launches += 1
    return out


sor_redblack_fused.launches = 0


def sor_redblack_tiled(p: torch.Tensor, rhs_c: torch.Tensor, dx: float,
                       dy: float, beta: float, tol: float, max_iter: int,
                       k: int = 8) -> torch.Tensor:
    """Plain twin of K5: the TPU tiled kernels' gate semantics on full-grid
    red-black sweeps. Groups of k sweeps run between gates; the gate reads
    the last sweep's max|dp|; err starts at inf and it at 1 and goes up by
    k, so the solve may run up to k-1 sweeps past `sor_redblack`'s stop."""
    masks = poisson.checkerboard(*p.shape, device=p.device)
    tol = poisson.dtype_float(tol, p.dtype)
    err, it = math.inf, 1
    while err > tol and it < max_iter:
        for _ in range(k - 1):
            p = poisson.redblack_sweep(p, rhs_c, dx, dy, beta, masks)
        p_new = poisson.redblack_sweep(p, rhs_c, dx, dy, beta, masks)
        err = float((p_new - p).abs().max())
        p, it = p_new, it + k
    return p


def sor_redblack_multiblock(p: torch.Tensor, rhs_c: torch.Tensor, dx: float,
                            dy: float, beta: float, tol: float, max_iter: int,
                            k: int = 8) -> torch.Tensor:
    """Red-black SOR for grids beyond one block (K5), any shape. Each
    launch of the C entry runs one group of k sweeps (2k colour
    half-sweep grids) and leaves the last sweep's max|dp| in a device
    scalar; the host reads it once per group and applies the same gate as
    `sor_redblack_tiled`."""
    if p.device.type == "cpu":
        return sor_redblack_tiled(p, rhs_c, dx, dy, beta, tol, max_iter, k)
    nx, ny = _build.check_inputs("sor_redblack_multiblock", p, rhs_c)
    dx2, dy2, denom = _consts(dx, dy)
    q = p.clone()  # updated in place by the kernel
    err_buf = torch.empty(1, dtype=p.dtype, device=p.device)
    fn = _build.entry("ns_sor_redblack_tiled_group", p.dtype)
    tol = poisson.dtype_float(tol, p.dtype)
    err, it = math.inf, 1
    with torch.cuda.device(p.device):
        s = _build.stream(p.device)
        while err > tol and it < max_iter:
            code = fn(q.data_ptr(), rhs_c.data_ptr(), err_buf.data_ptr(), nx,
                      ny, dx2, dy2, denom, float(beta), int(k), s)
            _build.check(code, "sor_redblack_multiblock")
            sor_redblack_multiblock.launches += 1
            # the kernel max-reduces |dp| on its bit pattern, which for a
            # non-negative value reads back as the value itself
            err = float(err_buf.item())
            it += k
    return q


sor_redblack_multiblock.launches = 0
