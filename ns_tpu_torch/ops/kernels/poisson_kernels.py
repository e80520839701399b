"""Pressure-solve kernels: wrappers of K1, K2, K4, K5
(`csrc/poisson_kernels.cu`).

Each wrapper replaces a kernel of `ns_tpu/ops/pallas/poisson_kernels.py`
and keeps a plain twin:
  K2 `jacobi_fused`            <- `jacobi_fused_pallas`;
                                  twin `ops.poisson.jacobi` + `apply_bcs`
  K2 `jacobi_multiblock`       <- the same, beyond one block (the grids where
                                  the JAX package runs its XLA Jacobi); same
                                  twin
  K1 `sor_redblack_fused`      <- `sor_redblack_fused_pallas`;
                                  twin `ops.poisson.sor_redblack`
  K4 `sor_redblack_packed_multiblock`
                               <- `sor_redblack_packed_tiled_pallas`, with
                                  `pack_redblack`/`unpack_redblack` (here,
                                  plain torch); twin
                                  `sor_redblack_packed_tiled` (here)
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
its gate once per k sweeps; K4 runs all k sweeps of a gate group in one
launch, each block on a 2D tile of the packed colour planes with the halo
their dependency cone needs; K2's multi-block form runs each sweep as one
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


# --- K4: packed red/black planes ---------------------------------------------
#
#   R[i, jc] = p[i, 2*jc + i%2]        (cells with (i+j) even)
#   B[i, jc] = p[i, 2*jc + (i+1)%2]    (cells with (i+j) odd)
#
# Up/down neighbours of either colour are the other colour at the same
# packed column (rows i+-1); the left/right pair is other[jc] plus
# other[jc-1] or other[jc+1]: red pairs even rows with jc-1 and odd rows
# with jc+1, black the opposite. The iterate sequence is the red-black
# sweeps' (`sor_redblack_tiled`).

# own packed cells (rows, columns) of one K4 block; the halo is added
# around them (`packed_tile_bytes`)
PACKED_TILE = (64, 64)


def _rows_even(nx: int, device) -> torch.Tensor:
    return (torch.arange(nx, device=device) % 2 == 0)[:, None]


def pack_redblack(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(nx, ny) -> the packed colour planes (R, B), each (nx, ny/2)."""
    nx, ny = p.shape
    if ny % 2:
        raise ValueError(f"packed red-black planes need an even ny, got {ny}")
    rows_even = _rows_even(nx, p.device)
    even, odd = p[:, 0::2], p[:, 1::2]
    return torch.where(rows_even, even, odd), torch.where(rows_even, odd, even)


def unpack_redblack(R: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The (nx, 2 * ny2) grid of packed colour planes R, B."""
    nx, ny2 = R.shape
    rows_even = _rows_even(nx, R.device)
    even, odd = torch.where(rows_even, R, B), torch.where(rows_even, B, R)
    return torch.stack([even, odd], dim=2).reshape(nx, 2 * ny2)


def _packed_masks(nx: int, ny: int, device):
    """Interior masks of the R and B planes (by each cell's global j)."""
    ii = torch.arange(nx, device=device)[:, None]
    jc = torch.arange(ny // 2, device=device)[None, :]
    row_ok = (ii >= 1) & (ii <= nx - 2)
    jR = 2 * jc + ii % 2
    jB = 2 * jc + (ii + 1) % 2
    return (row_ok & (jR >= 1) & (jR <= ny - 2),
            row_ok & (jB >= 1) & (jB <= ny - 2))


def _packed_update(self_c, other, c, rows_even, red: bool, dx2, dy2, denom,
                   beta):
    """One colour's relaxation on its packed plane, in the TPU kernel's
    expression order (`color_update`)."""
    up = torch.roll(other, -1, 0)     # other[i+1, jc]
    down = torch.roll(other, 1, 0)    # other[i-1, jc]
    prev = torch.roll(other, 1, 1)    # other[i, jc-1]
    nxt = torch.roll(other, -1, 1)    # other[i, jc+1]
    shifted = (torch.where(rows_even, prev, nxt) if red
               else torch.where(rows_even, nxt, prev))
    lr = other + shifted
    return beta * (dy2 * (up + down) + dx2 * lr - c) / denom \
        + (1.0 - beta) * self_c


def sor_redblack_packed_tiled(p: torch.Tensor, rhs_c: torch.Tensor,
                              dx: float, dy: float, beta: float, tol: float,
                              max_iter: int, k: int = 8) -> torch.Tensor:
    """Plain twin of K4: full-grid red-black sweeps on the packed colour
    planes, with the TPU tiled kernels' gate (err starts at inf and it at
    1; each group runs k sweeps, it += k; the gate reads the last sweep's
    max|dp|). The iterate sequence is `sor_redblack_tiled`'s; ny must be
    even."""
    nx, ny = p.shape
    R, B = pack_redblack(p)
    cR, cB = pack_redblack(rhs_c)
    maskR, maskB = _packed_masks(nx, ny, p.device)
    rows_even = _rows_even(nx, p.device)
    dx2, dy2, denom = _consts(dx, dy)

    def sweep(R, B):
        R = torch.where(maskR, _packed_update(R, B, cR, rows_even, True, dx2,
                                              dy2, denom, beta), R)
        B = torch.where(maskB, _packed_update(B, R, cB, rows_even, False, dx2,
                                              dy2, denom, beta), B)
        return R, B

    tol = poisson.dtype_float(tol, p.dtype)
    err, it = math.inf, 1
    while err > tol and it < max_iter:
        for _ in range(k - 1):
            R, B = sweep(R, B)
        Rn, Bn = sweep(R, B)
        err = float(torch.maximum((Rn - R).abs().max(), (Bn - B).abs().max()))
        R, B, it = Rn, Bn, it + k
    return unpack_redblack(R, B)


def packed_tile_bytes(k: int, itemsize: int) -> int:
    """Shared memory of one K4 block: the R and B planes of its tile, own
    cells plus a halo of 2k rows and k packed columns on each side (the
    reach of k red-black sweeps: one cell per colour half-sweep)."""
    rows, cols = PACKED_TILE
    return 2 * (rows + 4 * k) * (cols + 2 * k) * itemsize


def sor_redblack_packed_multiblock(p: torch.Tensor, rhs_c: torch.Tensor,
                                   dx: float, dy: float, beta: float,
                                   tol: float, max_iter: int,
                                   k: int = 8) -> torch.Tensor:
    """Red-black SOR on packed colour planes for grids beyond one block
    (K4). Each launch runs one gate group of k full sweeps: every block
    loads a tile of R and B with its halo into shared memory, sweeps it k
    times and writes its own cells into the other buffers of a ping-pong
    pair, with the last sweep's max|dp| over its own cells folded into a
    device scalar. The host reads it once per group and applies the same
    gate as `sor_redblack_packed_tiled`. Any shape with an even ny."""
    if p.device.type == "cpu":
        return sor_redblack_packed_tiled(p, rhs_c, dx, dy, beta, tol,
                                         max_iter, k)
    nx, ny = _build.check_inputs("sor_redblack_packed_multiblock", p, rhs_c)
    smem = packed_tile_bytes(k, p.element_size())
    if k < 1 or smem > SMEM_BUDGET:
        raise ValueError(f"sor_redblack_packed_multiblock: k={k} needs "
                         f"{smem} bytes of shared memory per block")
    dx2, dy2, denom = _consts(dx, dy)
    R, B = pack_redblack(p)  # raises on an odd ny
    cR, cB = pack_redblack(rhs_c)
    R2, B2 = torch.empty_like(R), torch.empty_like(B)
    err_buf = torch.empty(1, dtype=p.dtype, device=p.device)
    fn = _build.entry("ns_sor_redblack_packed_group", p.dtype)
    tol = poisson.dtype_float(tol, p.dtype)
    rows, cols = PACKED_TILE
    err, it = math.inf, 1
    with torch.cuda.device(p.device):
        s = _build.stream(p.device)
        while err > tol and it < max_iter:
            code = fn(R.data_ptr(), B.data_ptr(), cR.data_ptr(),
                      cB.data_ptr(), R2.data_ptr(), B2.data_ptr(),
                      err_buf.data_ptr(), nx, ny, rows, cols, dx2, dy2, denom,
                      float(beta), int(k), s)
            _build.check(code, "sor_redblack_packed_multiblock")
            sor_redblack_packed_multiblock.launches += 1
            R, B, R2, B2 = R2, B2, R, B
            # max-reduced on the bit pattern, as in K5
            err = float(err_buf.item())
            it += k
    return unpack_redblack(R, B)


sor_redblack_packed_multiblock.launches = 0
