"""Direct (non-iterative) Poisson and Helmholtz solves by matrix DST.

Port of `ns_tpu/ops/fast_poisson.py`. The chorin_fd pressure system is an
inhomogeneous-Dirichlet 5-point Poisson problem on the interior (the
boundary ring of p held fixed). Its interior operator separates as
Lx P + P Ly^T with Lx = tridiag(1, -2, 1)/dx^2 of size m = nx-2, and Lx
diagonalizes exactly in the orthonormal, symmetric DST-I basis

    Sx[a, b] = sqrt(2/(m+1)) sin(pi (a+1)(b+1) / (m+1)),
    lam_x[b] = -(4/dx^2) sin^2(pi (b+1) / (2(m+1))),

so the solve is P = Sx ((Sx F' Sy) / (lam_x + lam_y)) Sy: four square
GEMMs and one elementwise product, where F' is the interior RHS with the
fixed boundary values lifted onto it. `make_mixed_poisson` does the same
for direct_fd's mixed Dirichlet/Neumann edges in the eigenbasis of each
axis's folded operator.

The bases and eigenvalues are built once in host float64 numpy and moved to
the device once: when the solver is built (DST), or at its first solve on a
device (mixed-BC, whose dtype may follow b's); the GEMMs run through
`ops.gemm.matmul` at the precision asked for ('highest' by default: fp32
with TF32 off on the card). These are plain torch on every device: the JAX
package runs them as XLA GEMMs, outside any Pallas kernel.

Every solve acts on the last two axes: a (B, nx, ny) batch of members (the
FD ensemble, which the JAX package runs under vmap) has its boundary lifts
and rebuilds done on the whole batch, and its GEMM chain run member by
member (`ops.gemm.each_member`), so each member keeps its single solve's
bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ns_tpu_torch.core.bc import apply_bcs
from ns_tpu_torch.ops.gemm import each_member, matmul


def _dst_basis(m: int, h: float) -> tuple[np.ndarray, np.ndarray]:
    """Orthonormal DST-I matrix (symmetric) and second-difference
    eigenvalues for the size-m zero-Dirichlet 1D Laplacian with grid
    spacing h, in float64."""
    a = np.arange(1, m + 1, dtype=np.float64)
    S = np.sqrt(2.0 / (m + 1)) * np.sin(np.pi * np.outer(a, a) / (m + 1))
    lam = -(4.0 / (h * h)) * np.sin(np.pi * a / (2.0 * (m + 1))) ** 2
    return S, lam


def _as_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _parity_split_ops(S_h: np.ndarray, dtype, precision, device):
    """Half-flop application of a symmetric reversal-parity transform.

    The DST-I matrix satisfies S[m-1-a, b] = (-1)^b S[a, b] (and, being
    symmetric, the same with a and b swapped): splitting the operand into
    its mirror-symmetric and antisymmetric halves turns every m x m GEMM
    into two (m/2) x (m/2) GEMMs. Eigen-space stays in even-first permuted
    order between the forward and inverse transforms.

    Returns (fwd_l, fwd_r, inv_l, inv_r, perm):
      fwd_l(X) = S @ X   with rows in even-first permuted order
      fwd_r(X) = X @ S   with columns in even-first permuted order
      inv_l(G) = S @ G   taking permuted-row G back to natural order
      inv_r(G) = G @ S   taking permuted-column G back to natural order
      perm     = the even-first index permutation (for eigenvalue tables)
    """
    m = S_h.shape[0]
    q, ce = m // 2, (m + 1) // 2  # pair count, even-family size
    odd = m % 2 == 1
    E_h = S_h[0::2, :ce]  # (ce, ce)
    O_h = S_h[1::2, :q]   # (q, q)
    E, O = _as_tensor(E_h, dtype, device), _as_tensor(O_h, dtype, device)
    Et, Ot = _as_tensor(E_h.T, dtype, device), _as_tensor(O_h.T, dtype, device)

    def mm(a, b):
        return matmul(a, b, precision)

    def fwd_l(X):
        rev = torch.flip(X[m - q:], [0])
        s, d = X[:q] + rev, X[:q] - rev
        if odd:  # the middle row pairs with itself; even family only
            s = torch.cat([s, X[q:q + 1]], dim=0)
        return torch.cat([mm(E, s), mm(O, d)], dim=0)

    def fwd_r(X):
        rev = torch.flip(X[:, m - q:], [1])
        s, d = X[:, :q] + rev, X[:, :q] - rev
        if odd:
            s = torch.cat([s, X[:, q:q + 1]], dim=1)
        return torch.cat([mm(s, Et), mm(d, Ot)], dim=1)

    def inv_l(G):
        A = mm(Et, G[:ce])  # mirror-even contribution
        B = mm(Ot, G[ce:])  # mirror-odd contribution
        return torch.cat([A[:q] + B, A[q:ce], torch.flip(A[:q] - B, [0])],
                         dim=0)

    def inv_r(G):
        A = mm(G[:, :ce], E)
        B = mm(G[:, ce:], O)
        return torch.cat([A[:, :q] + B, A[:, q:ce],
                          torch.flip(A[:, :q] - B, [1])], dim=1)

    perm = np.concatenate([np.arange(0, m, 2), np.arange(1, m, 2)])
    return fwd_l, fwd_r, inv_l, inv_r, perm


# grids below this interior size keep the plain 4-GEMM path. The value is
# the JAX package's TPU v5e crossover (between 128^2 and 256^2 full
# grids), kept for parity; the H100's own crossover is not measured yet
_PARITY_MIN_DIM = 192


def _resolve_parity(parity_split, m: int, k: int) -> bool:
    if parity_split is None:
        return min(m, k) >= _PARITY_MIN_DIM
    return bool(parity_split)


def _eigen_solver(Sx_h, Sy_h, inv_den_h, dtype, precision, parity_split,
                  device):
    """`apply(F) = Sx ((Sx F Sy) * inv_den) Sy` on the interior, with the
    parity-split engine or the plain four GEMMs."""
    m, k = Sx_h.shape[0], Sy_h.shape[0]
    if _resolve_parity(parity_split, m, k):
        fxl, _, ixl, _, permx = _parity_split_ops(Sx_h, dtype, precision,
                                                  device)
        _, fyr, _, iyr, permy = _parity_split_ops(Sy_h, dtype, precision,
                                                  device)
        inv_den = _as_tensor(inv_den_h[np.ix_(permx, permy)], dtype, device)
        return lambda F: iyr(ixl(fyr(fxl(F)) * inv_den))
    Sx, Sy = _as_tensor(Sx_h, dtype, device), _as_tensor(Sy_h, dtype, device)
    inv_den = _as_tensor(inv_den_h, dtype, device)

    def mm(a, b):
        return matmul(a, b, precision)

    return lambda F: mm(mm(Sx, mm(mm(Sx, F), Sy) * inv_den), Sy)


def make_dst_poisson(nx: int, ny: int, dx: float, dy: float,
                     dtype=torch.float32, precision: str | None = "highest",
                     parity_split: bool | None = None, device=None):
    """Build `solve(p, f) -> p`, replacing p's interior with the exact
    solution of laplace(p) = f (5-point) with p's boundary ring fixed.

    parity_split=None (auto) takes the half-flop even/odd engine
    (`_parity_split_ops`) where both interior sizes reach
    `_PARITY_MIN_DIM`; True/False force it. The two differ only by
    floating-point reassociation."""
    if nx < 3 or ny < 3:
        raise ValueError(f"need nx, ny >= 3, got {nx}x{ny}")
    Sx_h, lamx = _dst_basis(nx - 2, dx)
    Sy_h, lamy = _dst_basis(ny - 2, dy)
    inv_denom_h = 1.0 / (lamx[:, None] + lamy[None, :])  # all < 0: safe
    apply = _eigen_solver(Sx_h, Sy_h, inv_denom_h, dtype, precision,
                          parity_split, device)
    inv_dx2, inv_dy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)

    def solve(p: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        p = p.to(dtype)
        fi = f.to(dtype)[..., 1:-1, 1:-1].clone()
        # lift the fixed boundary values onto the interior RHS
        fi[..., 0, :] += -p[..., 0, 1:-1] * inv_dx2
        fi[..., -1, :] += -p[..., -1, 1:-1] * inv_dx2
        fi[..., :, 0] += -p[..., 1:-1, 0] * inv_dy2
        fi[..., :, -1] += -p[..., 1:-1, -1] * inv_dy2
        out = p.clone()
        out[..., 1:-1, 1:-1] = each_member(apply, fi)
        return out

    return solve


def make_dst_helmholtz(nx: int, ny: int, dx: float, dy: float, coeff: float,
                       dtype=torch.float32, precision: str | None = "highest",
                       parity_split: bool | None = None, device=None):
    """Build `solve(ring, rhs_int) -> w` for (I - coeff * laplace) w = rhs
    (5-point) on the interior, with w's boundary ring fixed to `ring`'s
    edge values. For coeff = dt*nu/2 this is the unsplit Crank-Nicolson
    diffusion solve of chorin_fd's method='helmholtz' predictor. The
    eigen-denominators 1 - coeff*(lam_x + lam_y) are >= 1."""
    if nx < 3 or ny < 3:
        raise ValueError(f"need nx, ny >= 3, got {nx}x{ny}")
    if coeff < 0:
        raise ValueError(f"need coeff >= 0, got {coeff}")
    Sx_h, lamx = _dst_basis(nx - 2, dx)
    Sy_h, lamy = _dst_basis(ny - 2, dy)
    inv_den_h = 1.0 / (1.0 - coeff * (lamx[:, None] + lamy[None, :]))
    apply = _eigen_solver(Sx_h, Sy_h, inv_den_h, dtype, precision,
                          parity_split, device)
    cx, cy = coeff / (dx * dx), coeff / (dy * dy)

    def solve(ring: torch.Tensor, rhs_int: torch.Tensor) -> torch.Tensor:
        ring = ring.to(dtype)
        rhs = rhs_int.to(dtype).clone()
        # (I - coeff*lap) couples boundary-adjacent interior cells to the
        # fixed ring: -coeff*w_b/h^2 moves to the RHS as +coeff*w_b/h^2
        rhs[..., 0, :] += cx * ring[..., 0, 1:-1]
        rhs[..., -1, :] += cx * ring[..., -1, 1:-1]
        rhs[..., :, 0] += cy * ring[..., 1:-1, 0]
        rhs[..., :, -1] += cy * ring[..., 1:-1, -1]
        out = ring.clone()
        out[..., 1:-1, 1:-1] = each_member(apply, rhs)
        return out

    return solve


def _mixed_axis_operator(n_total: int, h: float, lo, hi):
    """1D interior second-difference operator of one axis with the BC
    relations folded in. lo/hi are (kind, value, step) for the low/high
    edge, `step` being the BC's own dx (left/right) or dy (bottom/top):
      - dirichlet c:  p[0] = c            -> rhs lift -c/h^2
      - neumann g:    p[0] = p[1]-step*g  -> diagonal -2 -> -1,
                                             rhs lift +step*g/h^2
    (the high edge with the opposite sign). Returns (V, lam, rhs_lift),
    V orthonormal (np.linalg.eigh of the symmetric tridiagonal), float64."""
    m = n_total - 2
    L = (np.diag(np.full(m, -2.0)) + np.diag(np.ones(m - 1), 1)
         + np.diag(np.ones(m - 1), -1))
    lift = np.zeros(m)
    for end, (kind, value, step), sign in ((0, lo, +1.0), (m - 1, hi, -1.0)):
        if kind == "neumann":
            L[end, end] += 1.0  # -2 -> -1 (+= so m == 1 folds both ends)
            lift[end] += sign * value * step / (h * h)
        else:
            lift[end] -= value / (h * h)
    L /= h * h
    lam, V = np.linalg.eigh(L)
    return V, lam, lift


def _side_bcs(p_bc) -> dict:
    """Effective (kind, value, step) per side: the LAST BC in list order
    writing a side sets the edge values the interior reads (corners are
    never read by the 5-point stencil)."""
    eff = {}
    for bc in p_bc:
        step = bc.dx if bc.side in ("left", "right") else bc.dy
        eff[bc.side] = (bc.kind, float(bc.value), float(step))
    missing = [s for s in ("left", "right", "bottom", "top") if s not in eff]
    if missing:
        raise ValueError(
            f"exact mixed-BC solve needs one BC per side; missing {missing} "
            "(an unconstrained edge would pin to its previous values, which "
            "the direct solve cannot represent)")
    return eff


def make_mixed_poisson(nx: int, ny: int, h0: float, h1: float, p_bc,
                       dtype=None, precision: str | None = "highest"):
    """Direct solver for the fixed point of (Jacobi sweep + apply_bcs):
    the converged limit of direct_fd's pressure iteration.

    Interior cells satisfy (d2/daxis0^2)/h0^2 + (d2/daxis1^2)/h1^2 of p
    equals b, and each edge its BC relation. With one BC per side this
    separates into each axis's folded operator (`_mixed_axis_operator`)
    and four GEMMs in the mixed eigenbasis. `left`/`right` are the axis-0
    edges, `bottom`/`top` the axis-1 edges; direct_fd passes h0=dy, h1=dx.
    All-Neumann problems are singular: the zero eigenpair is deflated and
    the particular solution with no constant component is returned.

    Returns `solve(b) -> p`: the interior from the direct solve, edges and
    corners rebuilt by `apply_bcs` in list order. With dtype=None the
    solve follows b's dtype; the float64 host constants move to each
    (dtype, device) once, at the first solve there."""
    eff = _side_bcs(p_bc)
    V0_h, lam0, lift0 = _mixed_axis_operator(nx, h0, eff["left"],
                                             eff["right"])
    V1_h, lam1, lift1 = _mixed_axis_operator(ny, h1, eff["bottom"],
                                             eff["top"])
    den = lam0[:, None] + lam1[None, :]
    # deflate the all-Neumann nullspace pair (|lam| ~ 0 only there)
    tiny = np.abs(den) < 1e-12 * max(1.0 / h0**2, 1.0 / h1**2)
    inv_den_h = np.where(tiny, 0.0, 1.0 / np.where(tiny, 1.0, den))
    lift_h = lift0[:, None] + lift1[None, :]
    bcs = list(p_bc)
    consts = {}

    def constants(dt_, dev):
        if (dt_, dev) not in consts:
            consts[dt_, dev] = tuple(_as_tensor(a, dt_, dev) for a in
                                     (V0_h.T, V0_h, V1_h, V1_h.T, inv_den_h,
                                      lift_h))
        return consts[dt_, dev]

    def mm(a, b):
        return matmul(a, b, precision)

    def solve(b: torch.Tensor) -> torch.Tensor:
        dt_ = dtype or b.dtype
        V0t, V0, V1, V1t, inv_den, lift = constants(dt_, b.device)
        rhs = b.to(dt_)[..., 1:-1, 1:-1] + lift

        def chain(r):
            G = mm(mm(V0t, r), V1) * inv_den
            return mm(mm(V0, G), V1t)

        p = torch.zeros(b.shape, dtype=dt_, device=b.device)
        p[..., 1:-1, 1:-1] = each_member(chain, rhs)
        return apply_bcs(p, bcs)

    return solve


@functools.lru_cache(maxsize=32)
def _cached_dst_solver(nx: int, ny: int, dx: float, dy: float,
                       dtype: torch.dtype, precision, device: str):
    return make_dst_poisson(nx, ny, dx, dy, dtype=dtype, precision=precision,
                            device=device)


def poisson_dst(p: torch.Tensor, f: torch.Tensor, dx: float, dy: float,
                precision: str | None = "highest") -> torch.Tensor:
    """One-shot `make_dst_poisson` solve. The solver (bases on p's device)
    is memoised on (shape, spacing, dtype, precision, device), so repeated
    calls in a loop build it once."""
    solve = _cached_dst_solver(p.shape[-2], p.shape[-1], float(dx),
                               float(dy), p.dtype, precision, str(p.device))
    return solve(p, f)
