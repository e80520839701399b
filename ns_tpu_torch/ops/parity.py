"""Half-flop application of reversal-parity operators (general engine).

Port of `ns_tpu/ops/parity.py`. On the symmetric Gauss-Lobatto grid
x_i = cos(pi i/(N-1)) index reversal i -> N-1-i is the reflection
x -> -x, so the corrected Chebyshev derivative matrix D is reversal-ODD
(D[rev, rev] = -D) and D^2 and every Helmholtz / Uzawa operator built from
it is reversal-EVEN (M[rev, rev] = M). Splitting an operand into its
symmetric and antisymmetric halves turns each m x n GEMM into two
half-size GEMMs (half the MACs), for one add/subtract fold and a mirrored
concatenation: the DST trick of `ops/fast_poisson.py` for any
parity-equivariant matrix, square or not.

For the eigen-diagonalized solves the even operator block-diagonalizes in
the parity basis: `ParityEig` eigendecomposes the two half-size blocks
(host float64, `ops/cheb.py::eig_real`), so each eigen transform is two
half-size GEMMs per side.

The quirk-compat matrices have no such symmetry, so the parity engine is
corrected-mode only and `reversal_parity` is its runtime guard. Results
differ from the dense path by floating-point reassociation only.

The JAX module takes its matmul precision from the ambient
`jax.default_matmul_precision`; here every GEMM gets it explicitly as
`precision` (`ops/gemm.py::matmul`). At 'default' in float32 the constant
matrices are rounded to bf16 once, when they are built (f64 -> f32 ->
bf16, the rounding the TPU's DEFAULT applies to the f32 constant at every
product).
"""

from __future__ import annotations

import numpy as np
import torch

from ns_tpu_torch.ops.cheb import eig_real
from ns_tpu_torch.ops.gemm import matmul


def reversal_parity(M: np.ndarray, rtol: float = 1e-9) -> int | None:
    """+1 if M[rev, rev] == M, -1 if == -M (within rtol * max|M|), else
    None. Works for rectangular M (independent reversal per axis). The
    tolerance admits the construction rounding of the corrected matrices
    (~1e-12 relative by N=512); the quirk matrices break parity at O(1)."""
    R = M[::-1, ::-1]
    scale = np.abs(M).max() or 1.0
    if np.abs(R - M).max() <= rtol * scale:
        return +1
    if np.abs(R + M).max() <= rtol * scale:
        return -1
    return None


def gemm_table(M: np.ndarray, dtype, device, precision) -> torch.Tensor:
    """A host float64 matrix that only ever enters GEMMs, on `device` in
    `dtype`; at 'default' in float32 rounded on to bf16 once."""
    t = torch.as_tensor(np.ascontiguousarray(M), dtype=dtype, device=device)
    if precision == "default" and dtype == torch.float32:
        t = t.to(torch.bfloat16)
    return t


def _fold(X: torch.Tensor, axis: int, n: int):
    """Split X along `axis` (length n) into its symmetric half s (ceil(n/2)
    entries: pair sums / 2, the middle kept as it is) and antisymmetric
    half d (floor(n/2) entries: pair differences / 2)."""
    q = n // 2
    Xl = X.narrow(axis, 0, q)
    Xh = torch.flip(X.narrow(axis, n - q, q), dims=(axis,))
    s = 0.5 * (Xl + Xh)
    d = 0.5 * (Xl - Xh)
    if n % 2 == 1:
        s = torch.cat([s, X.narrow(axis, q, 1)], dim=axis)
    return s, d


def _unfold(s: torch.Tensor, d: torch.Tensor, axis: int, n: int):
    """Inverse of the fold: natural-order X from its symmetric part s
    (ceil(n/2)) and antisymmetric part d (floor(n/2)):
    X[:q] = s[:q] + d, X[mid] = s[mid], X[rev] = s[:q] - d."""
    q = n // 2
    s_lo = s.narrow(axis, 0, q)
    parts = [s_lo + d]
    if n % 2 == 1:
        parts.append(s.narrow(axis, q, 1))
    parts.append(torch.flip(s_lo - d, dims=(axis,)))
    return torch.cat(parts, dim=axis)


def _half_blocks(M: np.ndarray):
    """(sym_in, anti_in, floor(r/2), ceil(r/2)): the operator's action on
    half-vector parameterizations of symmetric and antisymmetric inputs
    (`ns_tpu/ops/parity.py::_half_blocks`)."""
    r, c = M.shape
    qr, cr = r // 2, (r + 1) // 2
    qc = c // 2
    sym_in = M[:, :qc] + M[:, c - qc:][:, ::-1]
    if c % 2 == 1:
        sym_in = np.concatenate([sym_in, M[:, qc:qc + 1]], axis=1)
    anti_in = M[:, :qc] - M[:, c - qc:][:, ::-1]
    return sym_in, anti_in, qr, cr


def make_parity_apply(M_h: np.ndarray, dtype, side: str = "left",
                      precision: str | None = "highest", device=None):
    """Half-flop closure for a reversal-parity matrix M:
    side='left': f(X) = M @ X (M on X's axis -2); side='right':
    f(X) = X @ M.T (M on X's axis -1). Leading batch dimensions broadcast.
    Raises if M has no parity."""
    sign = reversal_parity(M_h)
    if sign is None:
        raise ValueError("matrix has no reversal parity; use the dense path")
    r, c = M_h.shape
    sym_in, anti_in, qr, cr = _half_blocks(M_h)
    if sign == +1:
        A_np, B_np = sym_in[:cr], anti_in[:qr]  # sym->sym, anti->anti
    else:
        A_np, B_np = anti_in[:cr], sym_in[:qr]  # anti->sym, sym->anti
    A = gemm_table(A_np, dtype, device, precision)
    B = gemm_table(B_np, dtype, device, precision)
    mm = lambda a, b: matmul(a, b, precision)

    if side == "left":
        def apply(X):
            s, d = _fold(X, -2, c)
            if sign == +1:
                out_s, out_d = mm(A, s), mm(B, d)
            else:
                out_s, out_d = mm(A, d), mm(B, s)
            return _unfold(out_s, out_d, -2, r)
    elif side == "right":
        At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)

        def apply(X):
            s, d = _fold(X, -1, c)
            if sign == +1:
                out_s, out_d = mm(s, At), mm(d, Bt)
            else:
                out_s, out_d = mm(d, At), mm(s, Bt)
            return _unfold(out_s, out_d, -1, r)
    else:
        raise ValueError(f"side must be left|right, got {side!r}")
    return apply


class ParityEig:
    """Parity-block eigen machinery for a reversal-EVEN square operator.

    The two blocks (symmetric and antisymmetric subspaces) are
    eigendecomposed separately in host float64 (`eig_real`, with its
    complex-spectrum guard); each transform is two half-size GEMMs:
      forward(F, axis): eigen-basis coefficients of F along `axis`,
        PARITY-ORDERED (symmetric-block eigenvalues first, as `.lam`);
      inverse(G, axis): back to natural order.
    """

    def __init__(self, M_h: np.ndarray, label: str, dtype,
                 precision: str | None = "highest", device=None):
        if reversal_parity(M_h) != +1:
            raise ValueError(f"{label}: operator is not reversal-even; "
                             "parity eigen solve does not apply")
        m = M_h.shape[0]
        self.m = m
        q, ce = m // 2, (m + 1) // 2
        sym_in, anti_in, _, _ = _half_blocks(M_h)
        Me = sym_in[:ce]
        Mo = anti_in[:q]
        lam_e, Ve = eig_real(Me, f"{label} (even block)")
        lam_o, Vo = eig_real(Mo, f"{label} (odd block)")
        self.precision = precision
        self.lam = torch.as_tensor(np.concatenate([lam_e, lam_o]),
                                   dtype=dtype, device=device)
        table = lambda a: gemm_table(a, dtype, device, precision)
        self.Ve, self.Vo = table(Ve), table(Vo)
        self.Ve_inv, self.Vo_inv = table(np.linalg.inv(Ve)), \
            table(np.linalg.inv(Vo))
        # host copies for cross-instance operator-equality checks
        self._Me_np, self._Mo_np = Me, Mo

    def _mm(self, a, b):
        return matmul(a, b, self.precision)

    def forward(self, F: torch.Tensor, axis: int) -> torch.Tensor:
        s, d = _fold(F, axis, self.m)
        if axis in (-2, F.dim() - 2):
            ge = self._mm(self.Ve_inv, s)
            go = self._mm(self.Vo_inv, d)
        else:
            ge = self._mm(s, self.Ve_inv.transpose(-1, -2))
            go = self._mm(d, self.Vo_inv.transpose(-1, -2))
        return torch.cat([ge, go], dim=axis)

    def inverse(self, G: torch.Tensor, axis: int) -> torch.Tensor:
        ce = (self.m + 1) // 2
        Ge = G.narrow(axis, 0, ce)
        Go = G.narrow(axis, ce, self.m - ce)
        if axis in (-2, G.dim() - 2):
            s = self._mm(self.Ve, Ge)
            d = self._mm(self.Vo, Go)
        else:
            s = self._mm(Ge, self.Ve.transpose(-1, -2))
            d = self._mm(Go, self.Vo.transpose(-1, -2))
        return _unfold(s, d, axis, self.m)

    def same_blocks(self, other: "ParityEig") -> bool:
        return (np.array_equal(self._Me_np, other._Me_np)
                and np.array_equal(self._Mo_np, other._Mo_np))


class ParityEig2D:
    """Separable two-axis eigen solve.

    `solve` (QUADRANT form) folds the operand once per axis into its four
    parity quadrants (ss, sd, ds, dd), transforms each with its (x-block,
    y-block) eigenbasis pair, multiplies by the matching reciprocal
    eigenvalue grid and mirrors back: no parity-order concatenation.
    `solve_composed` runs the per-axis forward/inverse composition on one
    parity-ordered grid (`full_recip`). The two differ by floating-point
    reassociation only. The reciprocal grids are set-up constants
    (`denoms(fn)` -> mask/invert), so the step multiplies and never
    divides."""

    def __init__(self, hx: ParityEig, hy: ParityEig):
        self.hx, self.hy = hx, hy
        cex, cey = (hx.m + 1) // 2, (hy.m + 1) // 2
        self._lams = ((hx.lam[:cex], hy.lam[:cey]),
                      (hx.lam[:cex], hy.lam[cey:]),
                      (hx.lam[cex:], hy.lam[:cey]),
                      (hx.lam[cex:], hy.lam[cey:]))

    def quadrants(self, F: torch.Tensor):
        """(ss, sd, ds, dd) parity quadrants of F over its last two axes."""
        s, d = _fold(F, -2, self.hx.m)
        ss, sd = _fold(s, -1, self.hy.m)
        ds, dd = _fold(d, -1, self.hy.m)
        return ss, sd, ds, dd

    def assemble(self, ss, sd, ds, dd) -> torch.Tensor:
        s = _unfold(ss, sd, -1, self.hy.m)
        d = _unfold(ds, dd, -1, self.hy.m)
        return _unfold(s, d, -2, self.hx.m)

    def denoms(self, denom_fn):
        """The four quadrant divisor grids (ee, eo, oe, oo order)."""
        return tuple(denom_fn(lx[:, None], ly[None, :])
                     for lx, ly in self._lams)

    def solve(self, F: torch.Tensor, recips) -> torch.Tensor:
        """F -> eigen solve with the per-quadrant reciprocal grids."""
        hx, hy = self.hx, self.hy
        mm = hx._mm
        quads = self.quadrants(F)
        xf = (hx.Ve_inv, hx.Ve_inv, hx.Vo_inv, hx.Vo_inv)
        yf = (hy.Ve_inv, hy.Vo_inv, hy.Ve_inv, hy.Vo_inv)
        xb = (hx.Ve, hx.Ve, hx.Vo, hx.Vo)
        yb = (hy.Ve, hy.Vo, hy.Ve, hy.Vo)
        out = []
        for q, A, B, Ai, Bi, r in zip(quads, xf, yf, xb, yb, recips):
            g = mm(mm(A, q), B.transpose(-1, -2)) * r
            out.append(mm(mm(Ai, g), Bi.transpose(-1, -2)))
        return self.assemble(*out)

    def full_recip(self, recips) -> torch.Tensor:
        """Quadrant reciprocal grids -> one parity-ordered (m_x, m_y) grid
        for `solve_composed` (even-block rows and columns first)."""
        top = torch.cat([recips[0], recips[1]], dim=-1)
        bot = torch.cat([recips[2], recips[3]], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def solve_composed(self, F: torch.Tensor,
                       full_recip: torch.Tensor) -> torch.Tensor:
        """The same solve by the per-axis forward/inverse composition."""
        G = self.hy.forward(self.hx.forward(F, -2), -1)
        return self.hx.inverse(self.hy.inverse(G * full_recip, -1), -2)
