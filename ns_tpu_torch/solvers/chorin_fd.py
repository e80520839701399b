"""Chorin projection on a uniform FD grid.

Port of `ns_tpu/solvers/chorin_fd.py` (the reference chorin_fd family):

  - predictor, three modes:
      'explicit'      — Adams-Bashforth for advection AND diffusion, with
                        the reference's y-advection axis quirk under
                        `quirk_compat=True` (default). Kernel K3
                        (`ops/kernels::momentum_explicit_fused`) on a CUDA
                        tensor; on a CPU tensor its plain twin
                        `ops/kernels/momentum_kernels.py::momentum_explicit`,
                        which is this family's explicit predictor.
      'semi_implicit' — Adams-Bashforth advection + Crank-Nicolson
                        diffusion via an ADI two-sweep; the (N-2)x(N-2)
                        operators are inverted ONCE on the host in float64
                        and each sweep is one matmul (plain torch on every
                        device, as the JAX package leaves it to XLA).
                        Quirk mode keeps the reference's advection sign flip
                        and square-grid y-sweep.
      'helmholtz'     — the corrected unsplit Crank-Nicolson predictor:
                        (I - a lap) u* = u^n - dt (3/2 H^n - 1/2 H^{n-1})
                        + a lap u^n with a = dt nu/2, solved exactly in the
                        DST eigenbasis (`ops/fast_poisson.py::
                        make_dst_helmholtz`, built once per `make_step`).
  - pressure, by `pressure_mode`:
      'redblack'     — red-black SOR with the reference's relaxation
                       formula, tol and cap. On a CUDA tensor: K1
                       (`sor_redblack_fused`, whole solve in one block)
                       when two grids fit one block's shared memory; beyond
                       that, where the JAX package ran its packed kernel
                       (nx % 128 == 0 and ny % 256 == 0), K4
                       (`sor_redblack_packed_multiblock`), and on any
                       other grid K5 (`sor_redblack_multiblock`): gate
                       every 8 sweeps, a whole solve one launch with the
                       gate on the device where the card holds their tiles,
                       else one launch per gate group. On a CPU tensor,
                       the same routing to their twins.
      'gauss_seidel' — exact reference iterate order (wavefront sweeps).
      'cg'           — conjugate gradient on the same system.
      'multigrid'    — V-cycles (MGCG off 2^k+1 grids) on
                       laplace(p) = rhs_c / (dx^2 dy^2), `mg_cycles` of
                       them (`ops/multigrid.py`).
      'dst'          — the direct DST solve of the same system
                       (`ops/fast_poisson.py::make_dst_poisson`, built
                       once per `make_step`).
  - correction: u <- u* - dt/(2dx) * grad(p), central.
  - step order: predictor -> u/v BCs -> pressure -> p BCs -> correction
    (three `utils/profiling.py::named_scope`s, as the JAX step has);
    ICs get BCs applied once at init; (u^n, u^{n-1}) history threaded
    through the rollout.

Axis convention preserved from the reference: axis 0 carries
x-differences, the opposite of direct_fd.

The step takes one state of (nx, ny) fields or a batch of members, fields
(B, nx, ny), as the JAX package's FD ensemble runs its step under vmap
(`parallel/ensemble.py::ensemble_fd_rollout`; the step's
`batch_polymorphic` attribute says so). Stencils, BC writes and the
kernels take the whole batch: K1 and K3 one launch a step for all
members; K4 and K5, which fill the card with one member's tiles, solve the
members in turn. The GEMM stages (ADI sweeps, dst, helmholtz) and the
host-gated pressure modes ('gauss_seidel', 'cg') run member by member, so
each member keeps its single rollout's bits (`ops.gemm.each_member`).

`gemm_precision` in float32 (float64 matmuls are always float64):
None, 'highest' and 'high' -> full fp32 (TF32 off; the TPU's HIGH is
bf16x3, which fp32 meets, `ops/gemm.py`); 'default' -> bf16 inputs with
fp32 accumulation. It sets the ADI, dst and
helmholtz GEMMs. On the TPU, None meant the jnp default (bf16 passes) for
the ADI sweeps and HIGHEST for dst and helmholtz; here it means fp32 for
all three.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ns_tpu_torch.core.bc import BC, apply_bcs, bcs_from_reference
from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.core.state import FlowState, rollout
from ns_tpu_torch.ops.fast_poisson import (make_dst_helmholtz,
                                           make_dst_poisson)
from ns_tpu_torch.ops.gemm import each_member, matmul
from ns_tpu_torch.ops.kernels import (momentum_explicit_fused, smem_fits,
                                      sor_redblack_fused,
                                      sor_redblack_multiblock,
                                      sor_redblack_packed_multiblock)
from ns_tpu_torch.ops.multigrid import poisson_multigrid
from ns_tpu_torch.ops.poisson import cg_poisson, sor_wavefront
from ns_tpu_torch.utils.profiling import named_scope


@dataclasses.dataclass(frozen=True)
class ChorinFDConfig:
    """Constructor-parameter parity with the reference chorin_fd system."""

    nt: int = 200
    nit: int = 50
    nx: int = 50
    ny: int = 50
    dt: float = 0.001
    rho: float = 1.0
    nu: float = 1.0
    beta: float = 1.25
    method: str = "semi_implicit"  # 'explicit'|'semi_implicit'|'helmholtz'
    sor_tol: float = 5e-6
    quirk_compat: bool = True  # replicate the reference's numerics quirks
    # 'redblack' | 'gauss_seidel' | 'multigrid' | 'cg' | 'dst'
    pressure_mode: str = "redblack"
    mg_cycles: int = 6  # V-cycles (or MGCG iterations) of 'multigrid'
    # ADI, dst and helmholtz GEMMs; see module docstring
    gemm_precision: str | None = None

    def __post_init__(self):
        if self.method not in ("semi_implicit", "explicit", "helmholtz"):
            raise ValueError("method must be semi_implicit|explicit|"
                             f"helmholtz, got {self.method!r}")
        if self.pressure_mode not in ("redblack", "gauss_seidel",
                                      "multigrid", "cg", "dst"):
            raise ValueError("pressure_mode must be redblack|gauss_seidel|"
                             f"multigrid|cg|dst, got {self.pressure_mode!r}")
        if self.gemm_precision not in (None, "default", "high", "highest"):
            raise ValueError("gemm_precision must be None|default|high|"
                             f"highest, got {self.gemm_precision!r}")
        if (self.method == "semi_implicit" and self.quirk_compat
                and self.nx != self.ny):
            raise ValueError(
                "semi_implicit with quirk_compat=True replicates the "
                "reference's square-grid ADI y-sweep and needs nx == ny; got "
                f"{self.nx}x{self.ny}. Set quirk_compat=False for the "
                "corrected rectangular sweep.")

    @property
    def dx(self) -> float:
        return 2.0 / (self.nx - 1)

    @property
    def dy(self) -> float:
        return 2.0 / (self.ny - 1)


def _adi_inverses(cfg: ChorinFDConfig, dtype, device):
    """Crank-Nicolson ADI operator inverses: the reference's tridiagonal A
    (x-sweep) and B (y-sweep), inverted once in float64 on the host."""
    dt, dx, dy, nu = cfg.dt, cfg.dx, cfg.dy, cfg.nu
    n, m = cfg.nx - 2, cfg.ny - 2
    A = (np.diag(np.full(n, 2.0 / nu * dx**2 + 2.0 * dt))
         + np.diag(np.full(n - 1, -dt), -1) + np.diag(np.full(n - 1, -dt), 1))
    B = (np.diag(np.full(m, 2.0 / nu * dy**2 + 2.0 * dt))
         + np.diag(np.full(m - 1, -dt), -1) + np.diag(np.full(m - 1, -dt), 1))
    as_t = lambda M: torch.as_tensor(np.linalg.inv(M), dtype=dtype,
                                     device=device)
    return as_t(A), as_t(B)


def _advect(cfg: ChorinFDConfig, f, g, h):
    """f * dh/dx + g * dh/dy on the interior, centred, axis 0 = x."""
    dx, dy = cfg.dx, cfg.dy
    return (f[..., 1:-1, 1:-1] * (h[..., 2:, 1:-1] - h[..., :-2, 1:-1])
            / (2.0 * dx)
            + g[..., 1:-1, 1:-1] * (h[..., 1:-1, 2:] - h[..., 1:-1, :-2])
            / (2.0 * dy))


def _lap(cfg: ChorinFDConfig, h):
    """5-point Laplacian of h on the interior."""
    dx, dy = cfg.dx, cfg.dy
    return ((h[..., 2:, 1:-1] - 2 * h[..., 1:-1, 1:-1] + h[..., :-2, 1:-1])
            / dx**2
            + (h[..., 1:-1, 2:] - 2 * h[..., 1:-1, 1:-1] + h[..., 1:-1, :-2])
            / dy**2)


def _semi_implicit_predictor(cfg: ChorinFDConfig, A_inv, B_inv, un, vn, un1,
                             vn1):
    """AB advection + Crank-Nicolson ADI diffusion, the per-step dense
    solves replaced by matmuls against precomputed inverses (member by
    member on a batch)."""
    dt, dx, dy, nu = cfg.dt, cfg.dx, cfg.dy, cfg.nu
    mm = lambda a, b: matmul(a, b, cfg.gemm_precision)

    def sweeps(hn, hn1, Hn, Hn1):
        # x-sweep: A ht = C. Quirk mode keeps the reference's advection
        # sign flip (it ADDS +dt/2 (3H - H1)); corrected mode subtracts.
        sgn = 1.0 if cfg.quirk_compat else -1.0
        C1 = sgn * dt / 2.0 * (3.0 * Hn - Hn1)
        C2 = dt * nu * _lap(cfg, hn)
        C = 2.0 / nu * dx**2 * (C1 + C2)
        ht = each_member(lambda c: mm(A_inv, c), C)
        # y-sweep: B hi = S
        S = (2.0 / nu * dy**2 * (ht + hn[..., 1:-1, 1:-1])
             - dt * (hn[..., 1:-1, 2:] - 2 * hn[..., 1:-1, 1:-1]
                     + hn[..., 1:-1, :-2]))
        if cfg.quirk_compat:
            # reference quirk: the y operator applied along the x axis
            # (only meaningful for nx == ny)
            return each_member(lambda s: mm(B_inv, s), S)
        # corrected: lift the wall values onto the y-sweep RHS and apply
        # the y operator along y
        S = S.clone()
        S[..., :, 0] += dt * hn[..., 1:-1, 0]
        S[..., :, -1] += dt * hn[..., 1:-1, -1]
        return each_member(lambda s: mm(s, B_inv.T), S)

    uHn, uHn1 = _advect(cfg, un, vn, un), _advect(cfg, un1, vn1, un1)
    vHn, vHn1 = _advect(cfg, un, vn, vn), _advect(cfg, un1, vn1, vn1)
    ui, vi = un.clone(), vn.clone()
    ui[..., 1:-1, 1:-1] = sweeps(un, un1, uHn, uHn1)
    vi[..., 1:-1, 1:-1] = sweeps(vn, vn1, vHn, vHn1)
    return ui, vi


def _helmholtz_predictor(cfg: ChorinFDConfig, hsolve, un, vn, un1, vn1):
    """Corrected unsplit Crank-Nicolson predictor (method='helmholtz'):
    (I - a lap) u* = u^n - dt (3/2 H^n - 1/2 H^{n-1}) + a lap u^n with
    a = dt nu/2 and H = u.grad(u) (physical sign), solved exactly by
    `hsolve` (`make_dst_helmholtz`) with u^n's boundary ring."""
    dt = cfg.dt
    a = dt * cfg.nu / 2.0
    uHn, uHn1 = _advect(cfg, un, vn, un), _advect(cfg, un1, vn1, un1)
    vHn, vHn1 = _advect(cfg, un, vn, vn), _advect(cfg, un1, vn1, vn1)
    rhs_u = (un[..., 1:-1, 1:-1] - dt * (1.5 * uHn - 0.5 * uHn1)
             + a * _lap(cfg, un))
    rhs_v = (vn[..., 1:-1, 1:-1] - dt * (1.5 * vHn - 0.5 * vHn1)
             + a * _lap(cfg, vn))
    return hsolve(un, rhs_u), hsolve(vn, rhs_v)


def _pressure_rhs(cfg: ChorinFDConfig, ui, vi):
    """Scaled divergence source of the SOR iteration."""
    dt, dx, dy, rho = cfg.dt, cfg.dx, cfg.dy, cfg.rho
    rhs = torch.zeros_like(ui)
    rhs[..., 1:-1, 1:-1] = (
        dx * rho * dy**2 / dt * (ui[..., 1:-1, 1:-1] - ui[..., :-2, 1:-1])
        + dy * rho * dx**2 / dt * (vi[..., 1:-1, 1:-1] - vi[..., 1:-1, :-2]))
    return rhs


def _correction(cfg: ChorinFDConfig, ui, vi, p):
    """Projection u <- u* - dt/(2h) grad p, central."""
    dt, dx, dy = cfg.dt, cfg.dx, cfg.dy
    u, v = ui.clone(), vi.clone()
    u[..., 1:-1, 1:-1] = (ui[..., 1:-1, 1:-1] - dt / (2.0 * dx)
                          * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1]))
    v[..., 1:-1, 1:-1] = (vi[..., 1:-1, 1:-1] - dt / (2.0 * dy)
                          * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2]))
    return u, v


def _pressure(cfg: ChorinFDConfig, p, rhs_c, dst_solve=None):
    # the SOR fixed point is laplace(p) = rhs_c / (dx^2 dy^2). Every route
    # takes a (B, nx, ny) batch: the wavefront and CG solve its members in
    # turn (host gates), the others the whole batch
    if cfg.pressure_mode == "gauss_seidel":
        return sor_wavefront(p, rhs_c, cfg.dx, cfg.dy, cfg.beta, cfg.sor_tol,
                             cfg.nit)
    if cfg.pressure_mode == "cg":
        f = rhs_c / (cfg.dx**2 * cfg.dy**2)
        return cg_poisson(p, f, cfg.dx, cfg.dy, tol=cfg.sor_tol,
                          max_iter=cfg.nit)
    if cfg.pressure_mode == "multigrid":
        f = rhs_c / (cfg.dx**2 * cfg.dy**2)
        return poisson_multigrid(p, f, cfg.dx, cfg.dy,
                                 n_cycles=cfg.mg_cycles)
    if cfg.pressure_mode == "dst":
        return dst_solve(p, rhs_c / (cfg.dx**2 * cfg.dy**2))
    if smem_fits(cfg.nx, cfg.ny, 2, p.element_size()):
        return sor_redblack_fused(p, rhs_c, cfg.dx, cfg.dy, cfg.beta,
                                  cfg.sor_tol, cfg.nit)
    if cfg.nx % 128 == 0 and cfg.ny % 256 == 0:
        return sor_redblack_packed_multiblock(p, rhs_c, cfg.dx, cfg.dy,
                                              cfg.beta, cfg.sor_tol, cfg.nit,
                                              k=8)
    return sor_redblack_multiblock(p, rhs_c, cfg.dx, cfg.dy, cfg.beta,
                                   cfg.sor_tol, cfg.nit, k=8)


def make_step(cfg: ChorinFDConfig, u_bc: Sequence[BC], v_bc: Sequence[BC],
              p_bc: Sequence[BC], dtype=torch.float32, device=None):
    """Build the one-timestep function. It takes one state or a batch of
    members (fields (B, nx, ny)); `step.batch_polymorphic` is True."""
    prec = cfg.gemm_precision or "highest"
    if cfg.method == "semi_implicit":
        A_inv, B_inv = _adi_inverses(cfg, dtype, device)
    elif cfg.method == "helmholtz":
        hsolve = make_dst_helmholtz(cfg.nx, cfg.ny, cfg.dx, cfg.dy,
                                    cfg.dt * cfg.nu / 2.0, dtype=dtype,
                                    precision=prec, device=device)
    dst_solve = None
    if cfg.pressure_mode == "dst":
        dst_solve = make_dst_poisson(cfg.nx, cfg.ny, cfg.dx, cfg.dy,
                                     dtype=dtype, precision=prec,
                                     device=device)

    def step(state: FlowState) -> FlowState:
        un, vn, p = state.u, state.v, state.p
        un1, vn1 = state.u_prev, state.v_prev
        with named_scope("chorin_fd.predictor"):
            if cfg.method == "explicit":
                # stencils + BC edge writes in one kernel call
                ui, vi = momentum_explicit_fused(
                    un, vn, un1, vn1, cfg.dt, cfg.dx, cfg.dy, cfg.nu, u_bc,
                    v_bc, quirk_compat=cfg.quirk_compat)
            else:
                if cfg.method == "helmholtz":
                    ui, vi = _helmholtz_predictor(cfg, hsolve, un, vn, un1,
                                                  vn1)
                else:
                    ui, vi = _semi_implicit_predictor(cfg, A_inv, B_inv, un,
                                                      vn, un1, vn1)
                ui, vi = apply_bcs(ui, u_bc), apply_bcs(vi, v_bc)
        with named_scope("chorin_fd.pressure"):
            p = apply_bcs(_pressure(cfg, p, _pressure_rhs(cfg, ui, vi),
                                    dst_solve), p_bc)
        with named_scope("chorin_fd.correction"):
            u_next, v_next = _correction(cfg, ui, vi, p)
        return FlowState(u=u_next, v=v_next, p=p, u_prev=un, v_prev=vn)

    step.batch_polymorphic = True
    return step


def init_state(cfg: ChorinFDConfig, u_ic, v_ic, p_ic, u_bc, v_bc, p_bc,
               dtype=torch.float32, device=None) -> FlowState:
    """Apply BCs to the ICs once and seed the AB history."""
    as_field = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return FlowState(u=apply_bcs(as_field(u_ic), u_bc),
                     v=apply_bcs(as_field(v_ic), v_bc),
                     p=apply_bcs(as_field(p_ic), p_bc)).with_history()


def simulate(cfg: ChorinFDConfig, state0: FlowState, u_bc, v_bc, p_bc):
    """Rollout returning stacked (nt, nx, ny) u, v, p fields, in the dtype
    and on the device of `state0`."""
    step = make_step(cfg, u_bc, v_bc, p_bc, dtype=state0.u.dtype,
                     device=state0.u.device)
    return rollout(step, state0, cfg.nt)


class NavierStokesSystem:
    """Reference-API wrapper: holds ICs, BC lists (this package's BCs or
    any with the same fields) and physics constants; the fields live on
    `device` (default CUDA; core/device.py)."""

    def __init__(self, u_ic, v_ic, p_ic, u_bc, v_bc, p_bc,
                 nt=200, nit=50, nx=50, ny=50, dt=0.001,
                 rho=1, nu=1, beta=1.25, method="semi_implicit",
                 dtype=torch.float32, quirk_compat=True,
                 pressure_mode="redblack", mg_cycles=6, gemm_precision=None,
                 device=None):
        device = resolve_device(device)
        self.cfg = ChorinFDConfig(nt=nt, nit=nit, nx=nx, ny=ny, dt=dt,
                                  rho=rho, nu=nu, beta=beta, method=method,
                                  quirk_compat=quirk_compat,
                                  pressure_mode=pressure_mode,
                                  mg_cycles=mg_cycles,
                                  gemm_precision=gemm_precision)
        self.u_bc, self.v_bc, self.p_bc = (bcs_from_reference(b)
                                           for b in (u_bc, v_bc, p_bc))
        self.state0 = init_state(self.cfg, u_ic, v_ic, p_ic, self.u_bc,
                                 self.v_bc, self.p_bc, dtype=dtype,
                                 device=device)
        self._step = make_step(self.cfg, self.u_bc, self.v_bc, self.p_bc,
                               dtype=dtype, device=device)

    def step(self, state: FlowState) -> FlowState:
        return self._step(state)

    def simulate(self):
        return rollout(self._step, self.state0, self.cfg.nt)
