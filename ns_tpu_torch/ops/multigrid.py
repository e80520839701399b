"""Geometric multigrid Poisson solver (V-cycles, red-black smoothing).

Port of `ns_tpu/ops/multigrid.py`. Solves laplace(p) = f on the interior
with the boundary values of p held fixed (the Dirichlet-frame problem of
the chorin_fd correction) on vertex-centred grids. Grids of 2^k + 1 points
per axis coarsen exactly and run stationary V-cycles; any other size is
embedded in the next 2^k + 1 grid with a masked interior and solved by
multigrid-preconditioned CG (`poisson_mgcg`), the original domain's
boundary and exterior held fixed at every level (the level-l mask is the
injection mask[::2, ::2] of the finer one).

Smoothing is red-black Gauss-Seidel, restriction full weighting,
prolongation bilinear, all plain torch on any device (the JAX package runs
them as XLA ops, outside any Pallas kernel). Every-other-point selection is
a strided slice: the JAX package's reshape form (`_every2`, `_interleave`)
exists to dodge a slow TPU gather and computes the same values. The CG
inner products are `torch.sum(a * b)`, which sums in another order than
XLA's `vdot`.

Every function acts on the last two axes: a (B, nx, ny) batch of members
(the FD ensemble, which the JAX package runs under vmap) is solved in one
call, each member with its own CG scalars.
"""

from __future__ import annotations

import torch

from ns_tpu_torch.ops.poisson import laplace_full


def _is_pow2_plus1(n: int) -> bool:
    return n >= 3 and ((n - 1) & (n - 2)) == 0


def _next_pow2_plus1(n: int) -> int:
    k = 1
    while (1 << k) + 1 < n:
        k += 1
    return (1 << k) + 1


def _parity_masks(mask: torch.Tensor):
    nx, ny = mask.shape
    ii = torch.arange(nx, device=mask.device)[:, None]
    jj = torch.arange(ny, device=mask.device)[None, :]
    parity = (ii + jj) % 2
    return (parity == 0) & mask, (parity == 1) & mask


def _smooth(p, f, hx2: float, hy2: float, mask, n_sweeps: int):
    """Red-black Gauss-Seidel sweeps for laplace(p) = f on `mask` cells."""
    red, black = _parity_masks(mask)
    denom = 2.0 / hx2 + 2.0 / hy2

    def gs(p):
        nbr = ((torch.roll(p, -1, -2) + torch.roll(p, 1, -2)) / hx2
               + (torch.roll(p, -1, -1) + torch.roll(p, 1, -1)) / hy2)
        return (nbr - f) / denom

    for _ in range(n_sweeps):
        p = torch.where(red, gs(p), p)
        p = torch.where(black, gs(p), p)
    return p


def _residual(p, f, hx2: float, hy2: float, mask):
    r = f - laplace_full(p, hx2, hy2)
    return torch.where(mask, r, 0.0)  # zero outside the solved region


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction to the (n+1)//2 vertex grid."""
    # 3x3 stencil [1 2 1; 2 4 2; 1 2 1]/16 applied at even fine vertices
    roll = torch.roll
    w = (4.0 * r
         + 2.0 * (roll(r, 1, -2) + roll(r, -1, -2) + roll(r, 1, -1)
                  + roll(r, -1, -1))
         + (roll(roll(r, 1, -2), 1, -1) + roll(roll(r, 1, -2), -1, -1)
            + roll(roll(r, -1, -2), 1, -1) + roll(roll(r, -1, -2), -1, -1))
         ) / 16.0
    return w[..., ::2, ::2]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """[a0 b0 a1 b1 ... b_{m-1} a_m] along `dim` (-2 or -1; a has one more
    entry)."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    if dim == -2:
        out[..., 0::2, :], out[..., 1::2, :] = a, b
    else:
        out[..., 0::2], out[..., 1::2] = a, b
    return out


def _prolong(e: torch.Tensor) -> torch.Tensor:
    """Bilinear prolongation from the coarse vertex grid to the fine one."""
    full_rows = _interleave(e, 0.5 * (e[..., :-1, :] + e[..., 1:, :]), -2)
    return _interleave(full_rows, 0.5 * (full_rows[..., :-1]
                                         + full_rows[..., 1:]), -1)


def _vcycle(p, f, hx: float, hy: float, mask, pre: int, post: int,
            min_n: int):
    nx, ny = p.shape[-2:]
    hx2, hy2 = hx * hx, hy * hy
    if min(nx, ny) <= min_n:
        return _smooth(p, f, hx2, hy2, mask, 50)  # coarsest: smooth to death
    p = _smooth(p, f, hx2, hy2, mask, pre)
    r_c = _restrict(_residual(p, f, hx2, hy2, mask))
    # a coarse vertex is free iff its coinciding fine vertex is: fixed cells
    # stay Dirichlet on every level
    mask_c = mask[::2, ::2]
    r_c = torch.where(mask_c, r_c, 0.0)
    e_c = _vcycle(torch.zeros_like(r_c), r_c, 2 * hx, 2 * hy, mask_c, pre,
                  post, min_n)
    # the correction is zero on fixed cells
    p = p + torch.where(mask, _prolong(e_c), 0.0)
    return _smooth(p, f, hx2, hy2, mask, post)


def _embed(p0: torch.Tensor, f: torch.Tensor):
    """(p_pad, f_pad, mask, exact): an arbitrary grid embedded in the next
    2^k+1 grid; mask marks the ORIGINAL interior (the solved cells)."""
    nx, ny = p0.shape[-2:]
    exact = _is_pow2_plus1(nx) and _is_pow2_plus1(ny)
    if exact:
        NX, NY = nx, ny
        p_pad, f_pad = p0, f
    else:
        NX, NY = _next_pow2_plus1(nx), _next_pow2_plus1(ny)
        p_pad = p0.new_zeros((*p0.shape[:-2], NX, NY))
        p_pad[..., :nx, :ny] = p0
        f_pad = f.new_zeros((*f.shape[:-2], NX, NY))
        f_pad[..., :nx, :ny] = f
    ii = torch.arange(NX, device=p0.device)[:, None]
    jj = torch.arange(NY, device=p0.device)[None, :]
    mask = (ii > 0) & (ii < nx - 1) & (jj > 0) & (jj < ny - 1)
    return p_pad, f_pad, mask, exact


def _dot(a, b):
    """The inner product of each member's grids (kept as (..., 1, 1) so that
    it scales its member)."""
    if a.dim() == 2:
        return torch.sum(a * b)
    return torch.sum(a * b, dim=(-2, -1), keepdim=True)


def poisson_mgcg(p0: torch.Tensor, f: torch.Tensor, dx: float, dy: float,
                 n_iters: int = 10, pre: int = 2, post: int = 2,
                 min_n: int = 3) -> torch.Tensor:
    """Multigrid-preconditioned conjugate gradient for laplace(p) = f with
    the boundary of p0 held fixed, on ANY grid size: n_iters CG
    iterations, each one V(pre, post) cycle plus one operator apply. The
    scalars stay on the device (no host sync)."""
    nx, ny = p0.shape[-2:]
    p_pad, f_pad, mask, exact = _embed(p0, f)
    dx2, dy2 = dx * dx, dy * dy

    def A(x):  # SPD form: A = -laplace on the masked subspace
        return torch.where(mask, -laplace_full(x, dx2, dy2), 0.0)

    def Minv(r):
        z = _vcycle(torch.zeros_like(r), torch.where(mask, r, 0.0), dx, dy,
                    mask, pre, post, min_n)
        return -torch.where(mask, z, 0.0)

    b = torch.where(mask, -f_pad, 0.0)
    r = b - A(p_pad)
    z = Minv(r)
    p, d, rz = p_pad, z, _dot(r, z)
    for _ in range(n_iters):
        Ad = A(d)
        alpha = rz / _dot(d, Ad)
        p = p + alpha * torch.where(mask, d, 0.0)
        r = r - alpha * Ad
        z = Minv(r)
        rz_new = _dot(r, z)
        d = z + (rz_new / rz) * d
        rz = rz_new
    return p if exact else p[..., :nx, :ny]


def poisson_multigrid(p0: torch.Tensor, f: torch.Tensor, dx: float,
                      dy: float, n_cycles: int = 8, pre: int = 2,
                      post: int = 2, min_n: int = 3) -> torch.Tensor:
    """Solve laplace(p) = f with the boundary of p0 held fixed: n_cycles
    stationary V-cycles on 2^k+1 grids, else `poisson_mgcg` with n_cycles
    CG iterations (the masked stationary cycle contracts as slowly as
    ~0.9x/cycle where the true boundary misaligns with a coarse level)."""
    _, _, mask, exact = _embed(p0, f)
    if not exact:
        return poisson_mgcg(p0, f, dx, dy, n_iters=n_cycles, pre=pre,
                            post=post, min_n=min_n)
    p = p0
    for _ in range(n_cycles):
        p = _vcycle(p, f, dx, dy, mask, pre, post, min_n)
    return p
