"""Chebyshev pseudospectral operator constructors (host-side, float64).

A verbatim copy of `ns_tpu/ops/cheb.py` (numpy only): the port imports
nothing of the JAX package, and both build bitwise-equal operators.

Builds the Gauss-Lobatto collocation machinery of the reference
chorin_spectral family (reference src/chorin_spectral/simulate.py:387-531):
transform matrices T / T^-1, first/second derivative matrices, and the
P_N - P_{N-2} pressure derivative matrix.

These are one-time O(N^2)..O(N^3) setup costs, so they are computed in NumPy
float64 on the host (vectorized — the reference uses python double loops)
and shipped to the device as constants (SURVEY.md §7 build plan item 4).

Reference quirks preserved deliberately (each gated by `quirk_compat`):
  - D^2 is built as D @ D.T (ref :493 carries a "FIXME: check this"), with
    the diagonal then overwritten by the negated *full* row sum of D @ D.T
    (ref :500-503 — the comment claims the diagonal is zero in the sum, but
    it is not). `quirk_compat=False` uses the correct D @ D.
  - the stable-form sin-product denominators use N (the point count) where
    the textbook formula uses N-1 (ref :456,472-473); replicated always,
    since both variants are self-consistent with the reference's T matrices.
"""

from __future__ import annotations

import numpy as np


def gauss_lobatto(N: int, k: int = 1) -> np.ndarray:
    """x_i = cos(k*pi*i/(N-1)), i = 0..N-1 (ref :395-399)."""
    i = np.arange(N)
    return np.cos(k * np.pi * i / float(N - 1))


def bar_c(N: int, quirk_compat: bool = True) -> np.ndarray:
    """bar_c_k = 2 if k in {0, N} else 1 (ref :391-393). With N points the
    k == N branch never fires, so the reference never doubles the last
    coefficient — preserved when quirk_compat. The corrected form doubles
    both endpoints (the textbook c-bar for Gauss-Lobatto)."""
    c = np.ones(N)
    c[0] = 2.0
    if not quirk_compat:
        c[-1] = 2.0
    return c


def t_matrix(N: int) -> np.ndarray:
    """Spectral->physical transform, T[k, i] = cos(k*pi*i/(N-1)) (ref :401-419)."""
    k = np.arange(N)[:, None]
    i = np.arange(N)[None, :]
    return np.cos(k * np.pi * i / float(N - 1))


def inv_t_matrix(N: int, quirk_compat: bool = True) -> np.ndarray:
    """Physical->spectral transform (ref :421-441):
    T^-1[i, k] = 2 cos(k*pi*i/(N-1)) / (bar_c_k * bar_c_i * N).
    The reference divides by N where the exact Gauss-Lobatto quadrature
    weight is N-1 (and misses the endpoint bar_c doubling) — preserved when
    quirk_compat; the corrected pair satisfies T @ T^-1 = I to roundoff."""
    c = bar_c(N, quirk_compat)
    norm = float(N if quirk_compat else N - 1)
    return 2.0 * t_matrix(N).T / (c[None, :] * c[:, None] * norm)


def d_matrix(N: int, quirk_compat: bool = True) -> np.ndarray:
    """First-derivative collocation matrix (ref :443-481): stable-form
    off-diagonals d_ij = (bar_c_i / bar_c_j) (-1)^{i+j} /
    (2 sin((j+i)pi/2M) sin((j-i)pi/2M)), diagonal = -row sum.

    The reference uses M = N (the point count) where the Gauss-Lobatto
    identity x_i - x_j = 2 sin((j+i)pi/2M) sin((j-i)pi/2M) requires
    M = N-1 — making its D an inaccurate derivative (measured ~0.67 max
    error differentiating x^3 - 2x at N=41) and the downstream scheme
    unstable. quirk_compat preserves that; the corrected form uses N-1 and
    the corrected bar_c, giving spectral accuracy."""
    c = bar_c(N, quirk_compat)
    M = float(N if quirk_compat else N - 1)
    i = np.arange(N)[:, None]
    j = np.arange(N)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = 2.0 * np.sin((j + i) * np.pi / (2.0 * M)) * \
            np.sin((j - i) * np.pi / (2.0 * M))
        D = (c[:, None] / c[None, :]) * ((-1.0) ** (i + j)) / denom
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -D.sum(axis=1))
    return D


def d_sqr_matrix(N: int, quirk_compat: bool = True) -> np.ndarray:
    """Second-derivative matrix (ref :483-504). quirk_compat reproduces the
    reference's D @ D.T (FIXME at :493) and its diagonal rule
    D2[i,i] = -(full row sum of D @ D.T) including the old diagonal
    (ref :500-503); the corrected form is plain D @ D on the corrected D."""
    D = d_matrix(N, quirk_compat)
    if not quirk_compat:
        return D @ D
    D2 = D @ D.T
    np.fill_diagonal(D2, -D2.sum(axis=1))
    return D2


def d_matrix_pn_minus_2(N: int, quirk_compat: bool = True) -> np.ndarray:
    """P_N - P_{N-2} pressure derivative matrix on the interior GL points,
    returning the (N-2, N-2) block.

    quirk_compat reproduces the reference formula verbatim (ref :506-531).
    That formula is not a differentiation matrix at all — measured max error
    ~26 applying it to f(x)=x on the interior nodes — which is one of the
    reasons the reference scheme diverges. The corrected form is the
    barycentric Lagrange differentiation matrix on the interior
    Gauss-Lobatto nodes (the degree-(N-3) interpolant's derivative), exact
    on polynomials up to that degree."""
    x = gauss_lobatto(N)
    xi = x[1:-1][:, None]
    xj = x[1:-1][None, :]
    if quirk_compat:
        j_idx = np.arange(1, N - 1)[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            off = ((-1.0) ** (j_idx + 1)) * (1.0 - xj**2) / \
                ((1.0 - xi**2) * (xi - xj))
        D = np.where(xi == xj, 0.0, off)
        diag = 3.0 * x[1:-1] / (2.0 * (1.0 - x[1:-1] ** 2))
        np.fill_diagonal(D, diag)
        return D
    # corrected: barycentric differentiation on the interior nodes
    nodes = x[1:-1]
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    # barycentric weights w_j = 1 / prod_{k != j} (x_j - x_k), computed in
    # log-magnitude for robustness at moderate N
    logw = -np.sum(np.log(np.abs(diff)), axis=1)
    sign = np.prod(np.sign(diff), axis=1)
    w = sign * np.exp(logw - logw.max())
    D = (w[None, :] / w[:, None]) / diff
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -D.sum(axis=1))
    return D


def eig_real(M: np.ndarray, label: str = "operator"):
    """Eigendecomposition with the reference's implicit realness assumption
    (TODO at ref :173). Raises if the spectrum is materially complex."""
    lam, V = np.linalg.eig(M)
    if np.abs(lam.imag).max() > 1e-9 * max(1.0, np.abs(lam.real).max()):
        raise ValueError(
            f"{label}: complex eigenvalues (max imag {np.abs(lam.imag).max():.3e}); "
            "the diagonalization trick needs a real spectrum")
    return lam.real.copy(), V.real.copy()
