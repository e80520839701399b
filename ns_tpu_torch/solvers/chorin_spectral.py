"""Chorin projection with Chebyshev pseudospectral collocation.

Port of `ns_tpu/solvers/chorin_spectral.py` (the reference chorin_spectral
family):

  - one-time set-up: Gauss-Lobatto mesh, derivative matrices D and D^2,
    Robin-style BC constants folded into modified interior operators,
    eigendecompositions of the BC-modified Helmholtz operators and of the
    P_N - P_{N-2} pressure operators Dx*DPx / Dy*DPy, with their inverses.
    All of it runs in float64 numpy on the host (`ops/cheb.py`, a copy of
    the JAX package's) and moves to the device once, as constants.
  - per step: the predictor solves the Helmholtz system 2u* - dt*Lap(u*) =
    F (AB advection + CN diffusion RHS) by the eigen transforms, an
    eigenvalue divide and the transforms back, then reconstructs the
    boundary rows and columns from the interior (corners stay zero, as in
    the reference). The correction solves the Uzawa system for the interior
    pressure by the same diagonalization.
  - the rollout threads (u^n, u^{n-1}) history as chorin_fd does.

The reference scheme is unstable at its own default config: from a zero
field with the lid, the fields grow ~1e5x a step and overflow by step ~6.
That is kept (quirk_compat=True, the default). The corrected operator mode
(quirk_compat=False) is stable, supports Neumann BCs, and at interiors of
192 and more (or with parity_split=True) runs every per-step GEMM as two
half-size GEMMs by the operators' reversal parity (`ops/parity.py`).

Every product of the step (GEMMs and matvecs) runs through
`ops/gemm.py::matmul` at `cfg.matmul_precision` ('highest' and 'high':
fp32 with TF32 off; 'default': bf16 inputs, fp32 result; float64 always
float64), as the JAX step traces under `jax.default_matmul_precision`.
The boundary reconstruction's sums of products are sums, not products
(as in JAX). No Pallas kernel lies on this path, so no CUDA kernel either:
the step is cuBLAS GEMMs and torch elementwise ops.

BCs: quirk mode supports Dirichlet only and raises like the reference;
the corrected mode also supports Neumann (g is the coordinate-direction
derivative, not the outward normal).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ns_tpu_torch.core.bc import BC, apply_bcs, bcs_from_reference
from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.core.state import FlowState
from ns_tpu_torch.ops import cheb
from ns_tpu_torch.ops.gemm import matmul
from ns_tpu_torch.ops.parity import (ParityEig, ParityEig2D, gemm_table,
                                     make_parity_apply, reversal_parity)


@dataclasses.dataclass(frozen=True)
class ChorinSpectralConfig:
    """Constructor-parameter parity with the reference chorin_spectral
    system (and the JAX package's config)."""

    nt: int = 200
    nit: int = 50  # kept for signature parity; unused (direct solves)
    nx: int = 50
    ny: int = 50
    dt: float = 0.001
    rho: float = 1.0
    nu: float = 1.0
    beta: float = 1.25  # kept for signature parity; unused
    quirk_compat: bool = True  # replicate D @ D.T second derivative
    # precision of every per-step product (float32 only; see docstring)
    matmul_precision: str = "highest"
    # Deflate the near-null constant-pressure mode of the Uzawa operator
    # (the reference divides by the ~0 eigenvalue sum)
    deflate_pressure_nullspace: bool = False
    # half-flop parity-split GEMMs: None = auto (corrected mode at interior
    # >= _PARITY_MIN_INTERIOR), True forces it (raises where an operator
    # has no parity), False forces the dense path
    parity_split: bool | None = None
    # eigen-solve schedule under parity_split: 'composed' or 'quadrant'
    # (ops/parity.py::ParityEig2D); None = 'composed'
    parity_eig_form: str | None = None

    @property
    def dx(self) -> float:
        return 2.0 / self.nx  # the reference's (unlike FD's 2/(n-1))

    @property
    def dy(self) -> float:
        return 2.0 / self.ny


def _process_bcs(bc_list: Sequence[BC], allow_neumann: bool = False):
    """Map the BC list to Robin constants per side. Dirichlet -> alpha=1,
    g=value. The side naming quirk is kept: top -> minus_y, bottom ->
    plus_y (the descending Gauss-Lobatto coordinate). Neumann (beta=1) only
    with `allow_neumann` (the corrected mode); otherwise it raises as the
    reference does."""
    c = {f"{w}_{s}": 0.0 for w in ("alpha", "beta", "g")
         for s in ("minus_x", "plus_x", "minus_y", "plus_y")}
    side_map = {"left": "minus_x", "right": "plus_x",
                "top": "minus_y", "bottom": "plus_y"}
    seen = set()
    for bc in bc_list:
        s = side_map[bc.side]
        seen.add(s)
        if bc.kind == "dirichlet":
            c[f"alpha_{s}"] = 1.0
        elif bc.kind == "neumann" and allow_neumann:
            c[f"beta_{s}"] = 1.0
        else:
            raise NotImplementedError(
                "chorin_spectral supports Dirichlet BCs only in quirk mode "
                "(the reference likewise raises, chorin_spectral/simulate.py"
                ":218-221); Neumann needs quirk_compat=False")
        c[f"g_{s}"] = float(bc.value)
    missing = set(side_map.values()) - seen
    if missing:
        raise ValueError(f"chorin_spectral needs BCs on all four sides; "
                         f"missing {missing}")
    return c


def _boundary_constants(D: np.ndarray, c: dict, axis: str):
    """e, c0-, c0+, cN-, cN+, b0, bN of one axis's 2x2 face solve."""
    am, ap = c[f"alpha_minus_{axis}"], c[f"alpha_plus_{axis}"]
    bm, bp = c[f"beta_minus_{axis}"], c[f"beta_plus_{axis}"]
    c0_minus = -bp * D[0, -1]
    c0_plus = am + bm * D[-1, -1]
    cN_plus = -bm * D[-1, 0]
    cN_minus = ap + bp * D[0, 0]
    e = c0_plus * cN_minus - c0_minus * cN_plus
    b0 = -c0_plus * bp * D[0, 1:-1] - c0_minus * bm * D[-1, 1:-1]
    bN = -cN_minus * bm * D[-1, 1:-1] - cN_plus * bp * D[0, 1:-1]
    return dict(e=e, c0_minus=c0_minus, c0_plus=c0_plus,
                cN_minus=cN_minus, cN_plus=cN_plus, b0=b0, bN=bN)


class _FieldOps:
    """Device constants for one velocity field's Helmholtz solve and its
    boundary rows. The BC constants are 0-d tensors in the solver dtype
    (as the JAX package casts them), so every combination of them is
    taken in that dtype."""

    def __init__(self, Dx, Dy, Dx_sqr, Dy_sqr, cbc, dtype, device,
                 precision, corrected: bool = False):
        kx = _boundary_constants(Dx, cbc, "x")
        ky = _boundary_constants(Dy, cbc, "y")
        g = {k: cbc[k] for k in
             ("g_minus_x", "g_plus_x", "g_minus_y", "g_plus_y")}
        if corrected:
            # the reconstructed boundary values substituted into the
            # interior Laplacian rows: a rank-2 outer-product update
            Mx = Dx_sqr[1:-1, 1:-1] + (1.0 / kx["e"]) * (
                np.outer(Dx_sqr[1:-1, 0], kx["b0"])
                + np.outer(Dx_sqr[1:-1, -1], kx["bN"]))
            My = Dy_sqr[1:-1, 1:-1] + (1.0 / ky["e"]) * (
                np.outer(Dy_sqr[1:-1, 0], ky["b0"])
                + np.outer(Dy_sqr[1:-1, -1], ky["bN"]))
        else:
            # the reference's BC-modified operators as written: the edge
            # vector broadcast row-wise (it only matters when beta != 0,
            # which the reference rejects)
            Mx = Dx_sqr[1:-1, 1:-1] + (1.0 / kx["e"]) * (
                kx["b0"] * Dx_sqr[1:-1, 0] + kx["bN"] * Dx_sqr[1:-1, -1])
            My = Dy_sqr[1:-1, 1:-1] + (1.0 / ky["e"]) * (
                ky["b0"] * Dy_sqr[1:-1, 0] + ky["bN"] * Dy_sqr[1:-1, -1])
        # host copies: operator equality (u and v share one batched solve)
        # and the parity engine's block eigendecompositions
        self._Mx_np, self._My_np = Mx, My
        self._dtype, self._device, self._precision = dtype, device, precision
        cast = lambda d: {k: torch.as_tensor(v, dtype=dtype, device=device)
                          for k, v in d.items()}
        self.kx, self.ky, self.g = cast(kx), cast(ky), cast(g)
        self.b0_x, self.bN_x = self.kx["b0"], self.kx["bN"]
        self.b0_y, self.bN_y = self.ky["b0"], self.ky["bN"]
        kx, ky, g = self.kx, self.ky, self.g
        # the BC data terms of the 2x2 face solves, taken once in the
        # solver dtype by the JAX expressions' operations (a two-term sum
        # is the same in either order): the near faces' numerators, the
        # near faces' values (the corrected predictor's lift) and the far
        # faces' values
        self.gx0_num = (kx["c0_minus"] * g["g_minus_x"]
                        + kx["c0_plus"] * g["g_plus_x"])
        self.gy0_num = (ky["c0_minus"] * g["g_minus_y"]
                        + ky["c0_plus"] * g["g_plus_y"])
        self.gx0 = self.gx0_num / kx["e"]
        self.gy0 = self.gy0_num / ky["e"]
        self.gxN = (kx["cN_minus"] * g["g_minus_x"]
                    + kx["cN_plus"] * g["g_plus_x"]) / kx["e"]
        self.gyN = (ky["cN_minus"] * g["g_minus_y"]
                    + ky["cN_plus"] * g["g_plus_y"]) / ky["e"]
        self._dense_eig_done = False

    def build_dense_eig(self):
        """Full-operator eigendecomposition for the dense Helmholtz path,
        deferred so that the parity path (half-size blocks) skips it."""
        if self._dense_eig_done:
            return
        dtype, device = self._dtype, self._device
        lamx, P = cheb.eig_real(self._Mx_np, "helmholtz-x")
        lamy, Q = cheb.eig_real(self._My_np, "helmholtz-y")
        table = lambda a: gemm_table(a, dtype, device, self._precision)
        self.lamx = torch.as_tensor(lamx, dtype=dtype, device=device)
        self.lamy = torch.as_tensor(lamy, dtype=dtype, device=device)
        self.P, self.Q = table(P), table(Q)
        self.P_inv, self.Q_inv = table(np.linalg.inv(P)), \
            table(np.linalg.inv(Q))
        self._dense_eig_done = True


def _setup(cfg: ChorinSpectralConfig, u_bc, v_bc, dtype, device):
    """One-time host-side construction of all device constants."""
    Nx, Ny = cfg.nx, cfg.ny
    prec = cfg.matmul_precision
    Dx = cheb.d_matrix(Nx, quirk_compat=cfg.quirk_compat)
    Dy = cheb.d_matrix(Ny, quirk_compat=cfg.quirk_compat)
    Dx_sqr = cheb.d_sqr_matrix(Nx, quirk_compat=cfg.quirk_compat)
    Dy_sqr = cheb.d_sqr_matrix(Ny, quirk_compat=cfg.quirk_compat)

    corrected = not cfg.quirk_compat
    u_ops, v_ops = (
        _FieldOps(Dx, Dy, Dx_sqr, Dy_sqr,
                  _process_bcs(bc, allow_neumann=corrected), dtype, device,
                  prec, corrected=corrected) for bc in (u_bc, v_bc))

    DPx = cheb.d_matrix_pn_minus_2(Nx, quirk_compat=cfg.quirk_compat)
    DPy = cheb.d_matrix_pn_minus_2(Ny, quirk_compat=cfg.quirk_compat)
    DxDPx = Dx[1:-1, 1:-1] @ DPx
    DyDPy = Dy[1:-1, 1:-1] @ DPy

    host = dict(Dx_rows=Dx[1:-1, :], Dy_rows=Dy[1:-1, :],
                Dx_sqr_rows=Dx_sqr[1:-1, :], Dy_sqr_rows=Dy_sqr[1:-1, :],
                DPx=DPx, DPy=DPy, DxDPx=DxDPx, DyDPy=DyDPy)
    table = lambda a: gemm_table(a, dtype, device, prec)
    if corrected:
        # the corrected step takes its GEMMs through the parity appliers or
        # the dense closures of make_step; the D^2 boundary columns enter
        # the predictor's lift elementwise
        consts = {
            key: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                 device=device)
            for key, a in (("Dx_sqr_c0", Dx_sqr[1:-1, 0]),
                           ("Dx_sqr_cN", Dx_sqr[1:-1, -1]),
                           ("Dy_sqr_c0", Dy_sqr[1:-1, 0]),
                           ("Dy_sqr_cN", Dy_sqr[1:-1, -1]))}
    else:
        consts = dict(
            Dx_int=table(Dx[1:-1, 1:-1]), Dy_int=table(Dy[1:-1, 1:-1]),
            Dx_sqr_int=table(Dx_sqr[1:-1, 1:-1]),
            Dy_sqr_int=table(Dy_sqr[1:-1, 1:-1]),
            Dx_bar=table(np.stack([Dx[1:-1, 0], Dx[1:-1, -1]]).T),
            Dy_bar=table(np.stack([Dy[1:-1, 0], Dy[1:-1, -1]]).T),
            DxDPx=table(DxDPx), DyDPy=table(DyDPy))
    return u_ops, v_ops, consts, host


def _add_dense_pressure_eig(consts: dict, host: dict, dtype, device,
                            precision) -> None:
    """Full-operator pressure eigendecomposition (dense path only)."""
    plamx, PP = cheb.eig_real(host["DxDPx"], "pressure-x")
    plamy, PQ = cheb.eig_real(host["DyDPy"], "pressure-y")
    table = lambda a: gemm_table(a, dtype, device, precision)
    consts.update(
        p_lamx=torch.as_tensor(plamx, dtype=dtype, device=device),
        p_lamy=torch.as_tensor(plamy, dtype=dtype, device=device),
        p_P=table(PP), p_Q=table(PQ),
        p_P_inv=table(np.linalg.inv(PP)), p_Q_inv=table(np.linalg.inv(PQ)))


# interior size at/above which auto mode enables parity splitting: the
# JAX package's value, measured on a TPU v5e and kept as it is
# (tools/torch_chebyshev_engines.py times both engines on the card)
_PARITY_MIN_INTERIOR = 192

_PARITY_EXPECTED = (  # (host key, expected reversal sign)
    ("Dx_rows", -1), ("Dy_rows", -1),
    ("Dx_sqr_rows", +1), ("Dy_sqr_rows", +1),
    ("DPx", -1), ("DPy", -1),
    ("DxDPx", +1), ("DyDPy", +1),
)


def _resolve_parity_split(cfg: ChorinSpectralConfig, u_ops, v_ops, host):
    """Whether this step runs the parity-split engine. Explicit True
    validates every per-step operator's reversal parity and raises naming
    the violators; auto (None) takes it silently where eligible: corrected
    mode, interior >= _PARITY_MIN_INTERIOR, all operators parity-clean."""
    if cfg.parity_split is False:
        return False
    explicit = cfg.parity_split is True
    if cfg.quirk_compat:
        if explicit:
            raise ValueError(
                "parity_split=True needs quirk_compat=False: the "
                "reference's quirk matrices (M=N sin denominators, "
                "single-endpoint bar_c) are not reversal-symmetric")
        return False
    if not explicit and min(cfg.nx, cfg.ny) - 2 < _PARITY_MIN_INTERIOR:
        return False
    bad = [k for k, want in _PARITY_EXPECTED
           if reversal_parity(host[k]) != want]
    for label, ops in (("u", u_ops), ("v", v_ops)):
        if reversal_parity(ops._Mx_np) != +1:
            bad.append(f"helmholtz-x[{label}]")
        if reversal_parity(ops._My_np) != +1:
            bad.append(f"helmholtz-y[{label}]")
    if bad:
        if explicit:
            raise ValueError(
                f"parity_split=True: operators without the required "
                f"reversal parity: {bad} (asymmetric BC data can break "
                "the operator's reflection equivariance)")
        return False
    return True


def _helmholtz_solve(F, ops: _FieldOps, denom, prec):
    """(2 - dt*Lap) u = F via eigen-diagonalization; `denom` is the
    eigenvalue grid 2 - dt lamx - dt lamy."""
    mm = lambda a, b: matmul(a, b, prec)
    H_hat = mm(mm(ops.P_inv, F), ops.Q_inv.T)
    return mm(ops.P, mm(H_hat / denom, ops.Q.T))


def _boundary_rows(soln, ops: _FieldOps, corrected: bool = False):
    """Edge rows/cols from the interior solve, as sums of elementwise
    products. The reference's far-face formulas drop the BC-data term;
    the corrected mode restores it."""
    kx, ky = ops.kx, ops.ky
    x0 = ((ops.b0_x[:, None] * soln).sum(0) + ops.gx0_num) / kx["e"]
    xN = (ops.bN_x[:, None] * soln).sum(0) / kx["e"]
    y0 = ((ops.b0_y[None, :] * soln).sum(1) + ops.gy0_num) / ky["e"]
    yN = (ops.bN_y[None, :] * soln).sum(1) / ky["e"]
    if corrected:
        xN = xN + ops.gxN
        yN = yN + ops.gyN
    return x0, xN, y0, yN


def _assemble(interior, edges):
    """Zeros + interior + 4 edges; corners stay zero (as the reference)."""
    x0, xN, y0, yN = edges
    out = torch.nn.functional.pad(interior, (1, 1, 1, 1))
    out[0, 1:-1] = x0
    out[-1, 1:-1] = xN
    out[1:-1, 0] = y0
    out[1:-1, -1] = yN
    return out


def _quirk_eig_guidance(cfg: ChorinSpectralConfig, e: ValueError):
    """The even-N quirk fail-fast: the reference-defect operators have a
    materially complex spectrum at every even N (every odd N in 9..63
    builds; the reference's own workload is odd, 51)."""
    return ValueError(
        f"quirk_compat=True cannot build a {cfg.nx}x{cfg.ny} grid: {e}. "
        "The reference's defective operators (D@D.T second derivative, "
        "M=N sin denominators) only have a real spectrum at ODD grid "
        "sizes (the reference's own workload is nx=ny=51, "
        "chorin_spectral/simulate.py:584); use an odd nx/ny, or "
        "quirk_compat=False for the corrected operators which build at "
        "any size")


def make_step(cfg: ChorinSpectralConfig, u_bc, v_bc, dtype=torch.float64,
              device=None):
    """Build the one-timestep function on `device` (CUDA for None;
    core/device.py). The returned `step(state)` carries two attributes:
    `step.cached(state, cache) -> (state, cache)` threads the AB-derivative
    cache through a rollout, bitwise equal to `step`, and
    `step.seed(state)` builds the first cache (None in quirk mode)."""
    device = resolve_device(device)
    prec = cfg.matmul_precision
    mm = lambda a, b: matmul(a, b, prec)
    u_ops, v_ops, C, host = _setup(cfg, u_bc, v_bc, dtype, device)
    dt, rho = cfg.dt, cfg.rho

    # all-Dirichlet BCs give u and v identical operators, so both
    # Helmholtz systems solve in ONE batched eigen transform
    same_ops = (np.array_equal(u_ops._Mx_np, v_ops._Mx_np)
                and np.array_equal(u_ops._My_np, v_ops._My_np))

    # corrected mode runs CN diffusion at the configured viscosity (the
    # reference never multiplies by nu; quirk mode keeps dt alone)
    dt_eff = dt if cfg.quirk_compat else cfg.nu * dt

    use_parity = _resolve_parity_split(cfg, u_ops, v_ops, host)

    if use_parity:
        # every per-step GEMM as two half-size GEMMs (ops/parity.py)
        pe = lambda M, label: ParityEig(M, label, dtype, prec, device)
        u_hx = pe(u_ops._Mx_np, "helmholtz-x[u]")
        u_hy = pe(u_ops._My_np, "helmholtz-y[u]")
        v_hx = u_hx if same_ops else pe(v_ops._Mx_np, "helmholtz-x[v]")
        v_hy = u_hy if same_ops else pe(v_ops._My_np, "helmholtz-y[v]")
        p_px = pe(host["DxDPx"], "pressure-x")
        p_py = pe(host["DyDPy"], "pressure-y")
        applier = lambda key, side: make_parity_apply(host[key], dtype, side,
                                                      prec, device)
        dx_l, dy_r = applier("Dx_rows", "left"), applier("Dy_rows", "right")
        dpx_l, dpy_r = applier("DPx", "left"), applier("DPy", "right")

        form = cfg.parity_eig_form or "composed"
        if form not in ("quadrant", "composed"):
            raise ValueError(f"parity_eig_form must be quadrant|composed|"
                             f"None, got {form!r}")
        u_h2d = ParityEig2D(u_hx, u_hy)
        v_h2d = u_h2d if same_ops else ParityEig2D(v_hx, v_hy)
        p_2d = ParityEig2D(p_px, p_py)
        # the reciprocal grids, in the solver dtype on the device as the
        # JAX package derives them
        h_fn = lambda lx, ly: 2.0 - dt_eff * lx - dt_eff * ly
        u_recips = tuple(1.0 / d for d in u_h2d.denoms(h_fn))
        v_recips = (u_recips if same_ops else
                    tuple(1.0 / d for d in v_h2d.denoms(h_fn)))
        p_denoms = p_2d.denoms(lambda lx, ly: lx + ly)
        if cfg.deflate_pressure_nullspace:
            dmax = torch.stack([d.abs().max() for d in p_denoms]).max()
            p_recips = tuple(
                torch.where(d.abs() > 1e-8 * dmax,
                            1.0 / torch.where(d.abs() > 1e-8 * dmax, d,
                                              torch.ones_like(d)),
                            torch.zeros_like(d))
                for d in p_denoms)
        else:
            p_recips = tuple(1.0 / d for d in p_denoms)
        if form == "composed":
            u_recips = u_h2d.full_recip(u_recips)
            v_recips = (u_recips if same_ops
                        else v_h2d.full_recip(v_recips))
            p_recips = p_2d.full_recip(p_recips)
            u_solve, v_solve, p_solve = (u_h2d.solve_composed,
                                         v_h2d.solve_composed,
                                         p_2d.solve_composed)
        else:
            u_solve, v_solve, p_solve = (u_h2d.solve, v_h2d.solve,
                                         p_2d.solve)

        def _solve_uv(u_F, v_F):
            if same_ops:
                soln = u_solve(torch.stack([u_F, v_F]), u_recips)
                return soln[0], soln[1]
            return u_solve(u_F, u_recips), v_solve(v_F, v_recips)

        def _psolve(H):
            return p_solve(H, p_recips)
    else:
        try:
            # with identical operators v's solve is u's: one set of
            # eigendecompositions serves both
            u_ops.build_dense_eig()
            if not same_ops:
                v_ops.build_dense_eig()
            _add_dense_pressure_eig(C, host, dtype, device, prec)
        except ValueError as e:
            if cfg.quirk_compat:
                raise _quirk_eig_guidance(cfg, e) from e
            raise
        if not cfg.quirk_compat:
            table = lambda a: gemm_table(a, dtype, device, prec)
            Dx_rows, Dy_rows = table(host["Dx_rows"]), table(host["Dy_rows"])
            DPx, DPy = table(host["DPx"]), table(host["DPy"])
            dx_l = lambda X: mm(Dx_rows, X)
            dy_r = lambda X: mm(X, Dy_rows.T)
            dpx_l = lambda X: mm(DPx, X)
            dpy_r = lambda X: mm(X, DPy.T)
        # the eigenvalue grids, once (the JAX step forms the same values)
        den = lambda o: 2.0 - dt_eff * o.lamx[:, None] - dt_eff * o.lamy[None, :]  # noqa: E731
        u_den = den(u_ops)
        v_den = u_den if same_ops else den(v_ops)
        p_den = C["p_lamx"][:, None] + C["p_lamy"][None, :]
        if cfg.deflate_pressure_nullspace:
            p_keep = p_den.abs() > 1e-8 * p_den.abs().max()
            p_den = torch.where(p_keep, p_den, torch.ones_like(p_den))

        def _solve_uv(u_F, v_F):
            if same_ops:
                soln = _helmholtz_solve(torch.stack([u_F, v_F]), u_ops,
                                        u_den, prec)
                return soln[0], soln[1]
            return (_helmholtz_solve(u_F, u_ops, u_den, prec),
                    _helmholtz_solve(v_F, v_ops, v_den, prec))

        def _psolve(H):
            H_hat = mm(mm(C["p_P_inv"], H), C["p_Q_inv"].T)
            Q_hat = H_hat / p_den
            if cfg.deflate_pressure_nullspace:
                Q_hat = torch.where(p_keep, Q_hat, torch.zeros_like(Q_hat))
            return mm(C["p_P"], mm(Q_hat, C["p_Q"].T))

    def predictor_ref(un, vn, un1, vn1):
        """AB advection + CN diffusion RHS and the Helmholtz solve, the
        reference algorithm: all derivative products use interior-only
        operator blocks, so boundary values never enter the RHS."""
        _un, _un1 = un[1:-1, 1:-1], un1[1:-1, 1:-1]
        _vn, _vn1 = vn[1:-1, 1:-1], vn1[1:-1, 1:-1]
        Dx, Dy = C["Dx_int"], C["Dy_int"]
        Dx2, Dy2 = C["Dx_sqr_int"], C["Dy_sqr_int"]

        def F_of(h, h1):
            h_dx, h_dy = mm(Dx, h), mm(h, Dy.T)
            h1_dx, h1_dy = mm(Dx, h1), mm(h1, Dy.T)
            h_ddx, h_ddy = mm(Dx2, h), mm(h, Dy2.T)
            return (2.0 * h
                    - 3.0 * dt * (_un * h_dx + _vn * h_dy)
                    + dt * (_un1 * h1_dx + _vn1 * h1_dy)
                    + dt * (h_ddx + h_ddy))

        u_soln, v_soln = _solve_uv(F_of(_un, _un1), F_of(_vn, _vn1))
        return (_assemble(u_soln, _boundary_rows(u_soln, u_ops)),
                _assemble(v_soln, _boundary_rows(v_soln, v_ops)))

    def predictor_corrected(un, vn, un1, vn1, cache=None):
        """Corrected-mode predictor: the same AB/CN Helmholtz structure with
        the FULL interior operator rows (boundary columns included) and the
        boundary values of u* lifted into the RHS. The CN diffusion term
        runs no explicit D^2 GEMM: with A = nu*dt*(Mx (+) My),
        u* = (2-A)^{-1} (4h - adv + nu*dt*lift_total) - h, and the
        Helmholtz eigen transforms absorb the diffusion operator; what is
        left of Lap.h beyond A.h is the rank-1 boundary algebra (`lift`)."""
        _un, _vn = un[1:-1, 1:-1], vn[1:-1, 1:-1]
        _un1, _vn1 = un1[1:-1, 1:-1], vn1[1:-1, 1:-1]

        def F_of(h_full, hd, h1d, ops):
            h = h_full[1:-1, 1:-1]
            h_dx, h_dy = hd
            h1_dx, h1_dy = h1d
            F = (4.0 * h
                 - 3.0 * dt * (_un * h_dx + _vn * h_dy)
                 + dt * (_un1 * h1_dx + _vn1 * h1_dy))
            # the boundary-column algebra of Lap.h plus the u* data lift,
            # four rank-1 outer products; each coefficient vector is the
            # boundary values of h less their reconstruction from the
            # interior, plus the data term. The matvecs take the step's
            # precision, as every product in the JAX step does.
            kx, ky = ops.kx, ops.ky
            cx0 = (h_full[0, 1:-1] - mm(ops.b0_x[None, :], h)[0] / kx["e"]
                   + ops.gx0)
            cxN = (h_full[-1, 1:-1] - mm(ops.bN_x[None, :], h)[0] / kx["e"]
                   + ops.gxN)
            cy0 = (h_full[1:-1, 0] - mm(h, ops.b0_y[:, None])[:, 0] / ky["e"]
                   + ops.gy0)
            cyN = (h_full[1:-1, -1] - mm(h, ops.bN_y[:, None])[:, 0]
                   / ky["e"] + ops.gyN)
            lift = (C["Dx_sqr_c0"][:, None] * cx0[None, :]
                    + C["Dx_sqr_cN"][:, None] * cxN[None, :]
                    + cy0[:, None] * C["Dy_sqr_c0"][None, :]
                    + cyN[:, None] * C["Dy_sqr_cN"][None, :])
            return F + cfg.nu * dt * lift, (h_dx, h_dy)

        # AB derivative reuse: this step's (h_dx, h_dy) of u^n is the next
        # step's (h1_dx, h1_dy), the identical GEMM on the identical
        # operand. The (u, v) derivatives run as ONE batch-2 apply a side;
        # the history pair gets its own batch-2 apply rather than a
        # batch-4 one, so that the (u, v) GEMM has the same shape in the
        # plain and the cached paths and the two stay bitwise equal.
        dxs = dx_l(torch.stack([un[:, 1:-1], vn[:, 1:-1]]))
        dys = dy_r(torch.stack([un[1:-1, :], vn[1:-1, :]]))
        if cache is None:
            dxs1 = dx_l(torch.stack([un1[:, 1:-1], vn1[:, 1:-1]]))
            dys1 = dy_r(torch.stack([un1[1:-1, :], vn1[1:-1, :]]))
            u1d, v1d = (dxs1[0], dys1[0]), (dxs1[1], dys1[1])
        else:
            u1d, v1d = (cache[0], cache[1]), (cache[2], cache[3])
        u_F, u_d = F_of(un, (dxs[0], dys[0]), u1d, u_ops)
        v_F, v_d = F_of(vn, (dxs[1], dys[1]), v1d, v_ops)
        u_soln, v_soln = _solve_uv(u_F, v_F)
        u_soln = u_soln - un[1:-1, 1:-1]
        v_soln = v_soln - vn[1:-1, 1:-1]
        ui = _assemble(u_soln, _boundary_rows(u_soln, u_ops, corrected=True))
        vi = _assemble(v_soln, _boundary_rows(v_soln, v_ops, corrected=True))
        return ui, vi, u_d + v_d

    if cfg.quirk_compat:
        predictor = lambda un, vn, un1, vn1, cache=None: (
            *predictor_ref(un, vn, un1, vn1), None)
    else:
        predictor = predictor_corrected

    Nx, Ny = cfg.nx, cfg.ny

    def correction(ui, vi, p):
        """Uzawa P_N - P_{N-2} pressure solve and the projection."""
        p_next = p.clone()
        if cfg.quirk_compat:
            # the reference form: interior divergence + the S boundary-flux
            # term as written
            gu, gv = u_ops.g, v_ops.g
            u_tau = torch.stack([gu["g_minus_x"].expand(Ny - 2),
                                 gu["g_plus_x"].expand(Ny - 2)])
            v_tau = torch.stack([gv["g_minus_y"].expand(Nx - 2),
                                 gv["g_plus_y"].expand(Nx - 2)]).T
            S = -(mm(C["Dx_bar"], u_tau) + mm(v_tau, C["Dy_bar"].T))
            H = -rho / dt * (S - mm(C["Dx_int"], ui[1:-1, 1:-1])
                             - mm(vi[1:-1, 1:-1], C["Dy_int"].T))
            Q = _psolve(H)
            # the reference subtracts (Dx @ DPx) @ Q, a second-derivative
            # product, not a gradient; kept for parity
            u_next, v_next = ui.clone(), vi.clone()
            u_next[1:-1, 1:-1] += -mm(C["DxDPx"], Q) * dt / rho
            v_next[1:-1, 1:-1] += -mm(Q, C["DyDPy"].T) * dt / rho
        else:
            # H = (rho/dt) div(u*) on the interior rows, boundary columns
            # (the lid flux) included
            H = rho / dt * (dx_l(ui[:, 1:-1]) + dy_r(vi[1:-1, :]))
            Q = _psolve(H)
            # u <- u* - (dt/rho) grad_{P_{N-2}} Q: the interior divergence
            # of u^{n+1} vanishes by construction; the boundary values are
            # functions of the interior, so they are re-derived
            u_int = ui[1:-1, 1:-1] - dpx_l(Q) * dt / rho
            v_int = vi[1:-1, 1:-1] - dpy_r(Q) * dt / rho
            u_next = _assemble(u_int, _boundary_rows(u_int, u_ops,
                                                     corrected=True))
            v_next = _assemble(v_int, _boundary_rows(v_int, v_ops,
                                                     corrected=True))
        p_next[1:-1, 1:-1] = Q
        return u_next, v_next, p_next

    def cached_step(state: FlowState, cache):
        """step plus the AB-derivative carry: cache is (u_dx, u_dy, v_dx,
        v_dy) of state.u_prev/v_prev; thread it through a rollout to skip
        recomputing them (bitwise-identical values). Pass None to
        recompute (quirk mode always returns None)."""
        ui, vi, new_cache = predictor(state.u, state.v, state.u_prev,
                                      state.v_prev, cache)
        u_next, v_next, p_next = correction(ui, vi, state.p)
        return FlowState(u=u_next, v=v_next, p=p_next,
                         u_prev=state.u, v_prev=state.v), new_cache

    def seed(state: FlowState):
        """The first derivative cache for cached_step (None in quirk
        mode)."""
        if cfg.quirk_compat:
            return None
        dxs = dx_l(torch.stack([state.u_prev[:, 1:-1],
                                state.v_prev[:, 1:-1]]))
        dys = dy_r(torch.stack([state.u_prev[1:-1, :],
                                state.v_prev[1:-1, :]]))
        return (dxs[0], dys[0], dxs[1], dys[1])

    def step(state: FlowState) -> FlowState:
        return cached_step(state, None)[0]

    step.cached = cached_step
    step.seed = seed
    step.parity_split = use_parity
    return step


def init_state(cfg: ChorinSpectralConfig, u_ic, v_ic, p_ic, u_bc, v_bc,
               dtype=torch.float64, device=None) -> FlowState:
    """Apply the velocity BCs to the ICs once and seed the history, on
    `device` (CUDA for None)."""
    device = resolve_device(device)
    as_field = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                         device=device)
    return FlowState(u=apply_bcs(as_field(u_ic), u_bc),
                     v=apply_bcs(as_field(v_ic), v_bc),
                     p=as_field(p_ic)).with_history()


def simulate(cfg: ChorinSpectralConfig, state0: FlowState, step_fn):
    """Rollout of cfg.nt steps: the stacked (nt, nx, ny) u, v, p. A step
    with the AB-derivative cache (`step_fn.cached`) threads it through."""
    seqs = tuple(torch.empty((cfg.nt, *state0.u.shape), dtype=state0.u.dtype,
                             device=state0.u.device) for _ in range(3))
    cached = getattr(step_fn, "cached", None)
    state, cache = state0, (step_fn.seed(state0) if cached else None)
    for n in range(cfg.nt):
        if cached is not None:
            state, cache = cached(state, cache)
        else:
            state = step_fn(state)
        seqs[0][n], seqs[1][n], seqs[2][n] = state.u, state.v, state.p
    return seqs


class NavierStokesSystem:
    """Reference-API wrapper (the reference takes no pressure BCs: the
    P_N - P_{N-2} pressure needs none). The fields live on `device`
    (default CUDA; core/device.py). `deflate_pressure_nullspace=None`
    means `not quirk_compat`."""

    def __init__(self, u_ic, v_ic, p_ic, u_bc, v_bc, nt=200, nit=50,
                 nx=50, ny=50, dt=0.001, rho=1, nu=1, beta=1.25,
                 dtype=torch.float64, quirk_compat=True,
                 deflate_pressure_nullspace=None,
                 matmul_precision="highest", parity_split=None,
                 device=None):
        device = resolve_device(device)
        if deflate_pressure_nullspace is None:
            deflate_pressure_nullspace = not quirk_compat
        self.cfg = ChorinSpectralConfig(
            nt=nt, nit=nit, nx=nx, ny=ny, dt=dt, rho=rho, nu=nu, beta=beta,
            quirk_compat=quirk_compat,
            deflate_pressure_nullspace=deflate_pressure_nullspace,
            matmul_precision=matmul_precision, parity_split=parity_split)
        self.u_bc, self.v_bc = (bcs_from_reference(b) for b in (u_bc, v_bc))
        self.state0 = init_state(self.cfg, u_ic, v_ic, p_ic, self.u_bc,
                                 self.v_bc, dtype=dtype, device=device)
        self._step = make_step(self.cfg, self.u_bc, self.v_bc, dtype=dtype,
                               device=device)

    def step(self, state: FlowState) -> FlowState:
        return self._step(state)

    def simulate(self):
        return simulate(self.cfg, self.state0, self._step)
