"""Elliptic pressure solvers in plain torch: Jacobi, red-black SOR, CG.

Port of `ns_tpu/ops/poisson.py`. These functions run on any device; they
are the plain twins of the hand-written kernels in `ops/kernels/`
(`sor_redblack` of K1, `jacobi` of K2) and the solvers' path for the modes
with no kernel (`sor_wavefront`, `cg_poisson`).

The convergence gates of `sor_wavefront` and `cg_poisson` are
`while_loop`s (torch's higher-order op, the counterpart of the JAX
package's `lax.while_loop`): `torch.export` records each as one loop of
its graph, and run eagerly each reads its gate back to the host once a
turn, as the Python loops it replaced did. `sor_redblack`, K1's twin,
keeps a Python loop: it runs inside K1's operator, which a trace does not
enter. K1 keeps that gate on the device instead. Gate semantics follow
the reference: err=1, it=1, loop while err > tol and it < max_iter, with
the comparison made in the field's dtype.

The grid is the last two axes, so a (B, nx, ny) batch of members is one
call, as the JAX package's FD ensemble runs these under vmap: `jacobi`
and the red-black sweep act on every member, and `sor_redblack` gates
each member on its own (JAX's vmapped while_loop: the loop runs while
any member's gate is open, and a member whose gate has closed is kept as
it was). `sor_wavefront` and `cg_poisson` solve a batch's members in turn.
"""

from __future__ import annotations

import torch
from torch._higher_order_ops.while_loop import while_loop_op


def dtype_float(x: float, dtype: torch.dtype) -> float:
    """`x` rounded to `dtype`: the JAX gates compare `err > tol` with a
    weakly typed tol, i.e. in the field's own precision."""
    return float(torch.tensor(x, dtype=dtype))


def solve_members(solve, p: torch.Tensor, rhs: torch.Tensor, *args):
    """`solve(p, rhs, *args)` on one field, or on each member of a (B, nx,
    ny) batch in turn, stacked: the host-gated solves (each member's gate
    read on its own) and the kernel routes that take a batch's members one
    after another."""
    if p.dim() == 2:
        return solve(p, rhs, *args)
    return torch.stack([solve(pm, cm, *args) for pm, cm in zip(p, rhs)])


def checkerboard(nx: int, ny: int, device=None):
    """Interior red ((i+j) even) and black ((i+j) odd) cell masks (of one
    grid; they broadcast over a batch)."""
    ii = torch.arange(nx, device=device)[:, None]
    jj = torch.arange(ny, device=device)[None, :]
    interior = (ii > 0) & (ii < nx - 1) & (jj > 0) & (jj < ny - 1)
    parity = (ii + jj) % 2
    return (parity == 0) & interior, (parity == 1) & interior


def _gs_update(p, rhs_c, dx2, dy2, denom, beta):
    up = torch.roll(p, -1, -2)     # p[i+1, j]
    down = torch.roll(p, 1, -2)    # p[i-1, j]
    right = torch.roll(p, -1, -1)  # p[i, j+1]
    left = torch.roll(p, 1, -1)    # p[i, j-1]
    return beta * (dy2 * (up + down) + dx2 * (right + left) - rhs_c) / denom \
        + (1.0 - beta) * p


def redblack_sweep(p, rhs_c, dx, dy, beta, masks):
    """One red half-sweep then one black half-sweep over the interior."""
    red, black = masks
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 * (dx2 + dy2)
    p = torch.where(red, _gs_update(p, rhs_c, dx2, dy2, denom, beta), p)
    return torch.where(black, _gs_update(p, rhs_c, dx2, dy2, denom, beta), p)


def sor_redblack(p: torch.Tensor, rhs_c: torch.Tensor, dx: float, dy: float,
                 beta: float, tol: float, max_iter: int) -> torch.Tensor:
    """Red-black SOR for the chorin_fd pressure system (the plain twin of
    K1, `ops/kernels/poisson_kernels.py::sor_redblack_fused`).

        p[i,j] = beta * (dy^2 (p[i+1,j]+p[i-1,j]) + dx^2 (p[i,j+1]+p[i,j-1])
                 - rhs_c[i,j]) / (2 dx^2 + 2 dy^2) + (1-beta) p[i,j]

    with the boundary of `p` held fixed, err = max|p - p_prev_sweep|, and
    the reference cap semantics (err=1, it=1; loop while err > tol and
    it < max_iter).

    A (B, nx, ny) batch gates each member on its own: err is per member,
    the sweep runs while any member's gate is open, and a member whose
    gate has closed keeps its p (and err), so it stops at its own sweep
    count with its single solve's bits.
    """
    return sor_redblack_counted(p, rhs_c, dx, dy, beta, tol, max_iter)[0]


def sor_redblack_counted(p: torch.Tensor, rhs_c: torch.Tensor, dx: float,
                         dy: float, beta: float, tol: float, max_iter: int):
    """`sor_redblack`, and the sweeps each member ran: (p, an int64 tensor
    of the batch's shape, 0-dim for one field)."""
    masks = checkerboard(*p.shape[-2:], device=p.device)
    tol = dtype_float(tol, p.dtype)
    err = torch.ones(p.shape[:-2], dtype=p.dtype, device=p.device)
    swept = torch.zeros(p.shape[:-2], dtype=torch.int64, device=p.device)
    it = 1
    while it < max_iter:
        open_ = err > tol
        if not bool(open_.any()):
            break
        p_new = redblack_sweep(p, rhs_c, dx, dy, beta, masks)
        err = torch.where(open_, (p_new - p).abs().amax(dim=(-2, -1)), err)
        p, it = torch.where(open_[..., None, None], p_new, p), it + 1
        swept += open_
    return p, swept


def sor_wavefront(p: torch.Tensor, rhs_c: torch.Tensor, dx: float, dy: float,
                  beta: float, tol: float, max_iter: int) -> torch.Tensor:
    """Exact-parity sequential SOR via anti-diagonal wavefronts.

    The reference's lexicographic Gauss-Seidel sweep updates p[i,j] from the
    already-updated p[i-1,j], p[i,j-1] and the old p[i+1,j], p[i,j+1]; cells
    on one anti-diagonal i+j=d are independent, so updating diagonal by
    diagonal reproduces the reference iterate sequence. Each stage gathers
    its diagonal's cells and scatters their update back. A (B, nx, ny)
    batch: the members in turn, each with its own gate.
    """
    if p.dim() == 3:
        return solve_members(sor_wavefront, p, rhs_c, dx, dy, beta, tol,
                             max_iter)
    nx, ny = p.shape
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 * (dx2 + dy2)
    ii = torch.arange(1, nx - 1, device=p.device)[:, None]
    jj = torch.arange(1, ny - 1, device=p.device)[None, :]
    flat = (ii * ny + jj).flatten()
    diag = (ii + jj).flatten()
    stages = [flat[diag == d] for d in range(2, nx + ny - 3)]
    tol = dtype_float(tol, p.dtype)

    def gate(p, err, it, *_):
        return (err > tol) & (it < max_iter)

    def sweep(p, err, it, c, *stages):
        q = p.flatten().clone()
        for idx in stages:
            up, down = q[idx + ny], q[idx - ny]
            right, left = q[idx + 1], q[idx - 1]
            q[idx] = beta * (dy2 * (up + down) + dx2 * (right + left)
                             - c[idx]) / denom + (1.0 - beta) * q[idx]
        p_new = q.view(nx, ny)
        return p_new, (p_new - p).abs().max(), it + 1

    err = torch.ones((), dtype=p.dtype, device=p.device)
    it = torch.ones((), dtype=torch.int64, device=p.device)
    # the tensors the body reads besides the carry are the loop's inputs
    # (consts), so a traced loop holds them as such
    return while_loop_op(gate, sweep, (p, err, it),
                         (rhs_c.flatten(), *stages))[0]


def jacobi(p: torch.Tensor, rhs: torch.Tensor, dx: float, dy: float,
           n_iter: int, bc_fn=None) -> torch.Tensor:
    """Plain Jacobi sweeps for laplace(p) = rhs with optional per-sweep BC
    re-application (the direct_fd pattern; the plain twin of K2,
    `ops/kernels/poisson_kernels.py::jacobi_fused`), on the last two axes
    (a leading member axis is a batch)."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 * (dx2 + dy2)
    for _ in range(n_iter):
        interior = (
            ((p[..., 1:-1, 2:] + p[..., 1:-1, :-2]) * dy2
             + (p[..., 2:, 1:-1] + p[..., :-2, 1:-1]) * dx2) / denom
            - dx2 * dy2 / denom * rhs[..., 1:-1, 1:-1]
        )
        p = p.clone()
        p[..., 1:-1, 1:-1] = interior
        if bc_fn is not None:
            p = bc_fn(p)
    return p


def laplace_full(x: torch.Tensor, dx2: float, dy2: float) -> torch.Tensor:
    """5-point Laplacian including boundary wrap cells (callers mask), on
    the last two axes."""
    return ((torch.roll(x, -1, -2) - 2 * x + torch.roll(x, 1, -2)) / dx2
            + (torch.roll(x, -1, -1) - 2 * x + torch.roll(x, 1, -1)) / dy2)


def cg_poisson(p0: torch.Tensor, rhs: torch.Tensor, dx: float, dy: float,
               tol: float = 1e-8, max_iter: int = 500) -> torch.Tensor:
    """Conjugate gradient for the interior Dirichlet-frame Poisson problem
    (boundary of p0 held fixed). A (B, nx, ny) batch: the members in turn,
    each with its own gate."""
    if p0.dim() == 3:
        return solve_members(cg_poisson, p0, rhs, dx, dy, tol, max_iter)
    dx2, dy2 = dx * dx, dy * dy
    boundary = torch.ones_like(p0, dtype=torch.bool)
    boundary[1:-1, 1:-1] = False
    zero = torch.zeros((), dtype=p0.dtype, device=p0.device)
    tol = dtype_float(tol, p0.dtype)

    def gate(e, r, d, rs, it, *_):
        return (torch.sqrt(torch.abs(rs)) > tol) & (it < max_iter)

    def iterate(e, r, d, rs, it, boundary, zero):
        Ad = torch.where(boundary, zero, laplace_full(d, dx2, dy2))
        alpha = rs / torch.sum(d * Ad)
        e = e + alpha * d
        r = r - alpha * Ad
        rs_new = torch.sum(r * r)
        d = r + (rs_new / rs) * d
        return e, r, d, rs_new, it + 1

    # interior correction e with homogeneous boundary: A e = r0
    r = torch.where(boundary, zero, rhs - laplace_full(p0, dx2, dy2))
    carry = (torch.zeros_like(p0), r, r.clone(), torch.sum(r * r),
             torch.zeros((), dtype=torch.int64, device=p0.device))
    e = while_loop_op(gate, iterate, carry, (boundary, zero))[0]
    return p0 + e
