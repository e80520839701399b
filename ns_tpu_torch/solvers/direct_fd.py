"""Direct finite-difference discretization of the 2D incompressible NSE.

Port of `ns_tpu/solvers/direct_fd.py` (the reference direct_fd family):

  - source term b from velocity divergence + quadratic terms, central
    differences
  - pressure, by `pressure_mode`: 'jacobi' runs `nit` fixed Jacobi sweeps,
    re-applying the pressure BCs after every sweep: kernel K2 on a CUDA
    tensor (`ops/kernels::jacobi_fused`, one block, where two grids fit its
    shared memory; `jacobi_multiblock` beyond), its plain twin on a CPU
    tensor. 'exact' solves the converged limit of that iteration directly
    in the mixed-BC eigenbasis (`ops/fast_poisson.py::make_mixed_poisson`,
    built once per `make_step`; h0=dy, h1=dx by the axis convention below)
  - momentum update: first-order backward (upwind) advection, central
    pressure gradient, central diffusion, explicit Euler in time
  - velocity BCs applied after the momentum update

Axis convention preserved from the reference stencils: axis 1 carries the
x-differences and axis 0 the y-differences, while the BC edge naming maps
'left' to A[0,:]. The domain is [-1,1]^2 via dx = 2/(nx-1).

The rollout is a Python loop of `step`s on the state's device, writing each
frame into preallocated (nt, nx, ny) tensors.

The step takes one state of (nx, ny) fields or a batch of members, fields
(B, nx, ny), as the JAX package's FD ensemble runs its step under vmap
(`step.batch_polymorphic`): the stencils and BC writes take the whole
batch, K2 one launch a step for all members, K2's multi-block form the
members in turn, and the 'exact' solve its GEMM chain member by member
(`ops.gemm.each_member`), so each member keeps its single rollout's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ns_tpu_torch.core.bc import BC, apply_bcs, bcs_from_reference
from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.core.state import FlowState, rollout
from ns_tpu_torch.ops.fast_poisson import make_mixed_poisson
from ns_tpu_torch.ops.kernels import (jacobi_fused, jacobi_multiblock,
                                      smem_fits)


@dataclasses.dataclass(frozen=True)
class DirectFDConfig:
    """Constructor-parameter parity with the reference direct_fd system."""

    nt: int = 200
    nit: int = 50
    nx: int = 50
    ny: int = 50
    dt: float = 0.001
    rho: float = 1.0
    nu: float = 0.1
    # 'jacobi': the reference's fixed nit sweeps with per-sweep BC
    # re-application. 'exact': the direct mixed-BC eigenbasis solve of
    # their converged limit.
    pressure_mode: str = "jacobi"

    def __post_init__(self):
        if self.pressure_mode not in ("jacobi", "exact"):
            raise ValueError("pressure_mode must be jacobi|exact, got "
                             f"{self.pressure_mode!r}")

    @property
    def dx(self) -> float:
        return 2.0 / (self.nx - 1)

    @property
    def dy(self) -> float:
        return 2.0 / (self.ny - 1)


def build_up_b(cfg: DirectFDConfig, u: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """Pressure-Poisson source term."""
    rho, dt, dx, dy = cfg.rho, cfg.dt, cfg.dx, cfg.dy
    dudx = (u[..., 1:-1, 2:] - u[..., 1:-1, :-2]) / (2.0 * dx)
    dvdy = (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) / (2.0 * dy)
    dudy = (u[..., 2:, 1:-1] - u[..., :-2, 1:-1]) / (2.0 * dy)
    dvdx = (v[..., 1:-1, 2:] - v[..., 1:-1, :-2]) / (2.0 * dx)
    b = torch.zeros_like(u)
    b[..., 1:-1, 1:-1] = (
        rho * (1.0 / dt) * (dudx + dvdy)
        - dudx**2
        - 2.0 * dudy * dvdx
        - dvdy**2
    )
    return b


def pressure_poisson(cfg: DirectFDConfig, p: torch.Tensor, b: torch.Tensor,
                     p_bc: Sequence[BC]) -> torch.Tensor:
    """`nit` Jacobi sweeps with per-sweep BC re-application: K2 in one
    block while its ping-pong pair fits shared memory, else its multi-block
    form (the routing chorin_fd uses between K1 and K5)."""
    if smem_fits(cfg.nx, cfg.ny, 2, p.element_size()):
        return jacobi_fused(p, b, cfg.dx, cfg.dy, cfg.nit, p_bc)
    return jacobi_multiblock(p, b, cfg.dx, cfg.dy, cfg.nit, p_bc)


def make_step(cfg: DirectFDConfig, u_bc: Sequence[BC], v_bc: Sequence[BC],
              p_bc: Sequence[BC]):
    """Build the one-timestep function. It takes one state or a batch of
    members (fields (B, nx, ny)); `step.batch_polymorphic` is True."""
    dt, dx, dy = cfg.dt, cfg.dx, cfg.dy
    rho, nu = cfg.rho, cfg.nu
    if cfg.pressure_mode == "exact":
        # axis 0 carries the y-differences here: h0=dy, h1=dx
        exact_solve = make_mixed_poisson(cfg.nx, cfg.ny, dy, dx, p_bc)

    def step(state: FlowState) -> FlowState:
        un, vn, p = state.u, state.v, state.p
        b = build_up_b(cfg, un, vn)
        if cfg.pressure_mode == "exact":
            p = exact_solve(b)
        else:
            p = pressure_poisson(cfg, p, b, p_bc)

        # the interior and its neighbours along axis 1 (x) and axis 0 (y),
        # on the last two axes
        c = (..., slice(1, -1), slice(1, -1))
        xm, xp = (..., slice(1, -1), slice(None, -2)), (..., slice(1, -1),
                                                        slice(2, None))
        ym, yp = (..., slice(None, -2), slice(1, -1)), (..., slice(2, None),
                                                        slice(1, -1))
        u = un.clone()
        v = vn.clone()
        u[c] = (
            un[c]
            - un[c] * dt / dx * (un[c] - un[xm])
            - vn[c] * dt / dy * (un[c] - un[ym])
            - dt / (2.0 * rho * dx) * (p[xp] - p[xm])
            + nu * (dt / dx**2 * (un[xp] - 2.0 * un[c] + un[xm])
                    + dt / dy**2 * (un[yp] - 2.0 * un[c] + un[ym]))
        )
        v[c] = (
            vn[c]
            - un[c] * dt / dx * (vn[c] - vn[xm])
            - vn[c] * dt / dy * (vn[c] - vn[ym])
            - dt / (2.0 * rho * dy) * (p[yp] - p[ym])
            + nu * (dt / dx**2 * (vn[xp] - 2.0 * vn[c] + vn[xm])
                    + dt / dy**2 * (vn[yp] - 2.0 * vn[c] + vn[ym]))
        )
        return FlowState(u=apply_bcs(u, u_bc), v=apply_bcs(v, v_bc), p=p)

    step.batch_polymorphic = True
    return step


def simulate(cfg: DirectFDConfig, state0: FlowState, u_bc, v_bc, p_bc):
    """Full rollout, returning stacked (nt, nx, ny) fields."""
    return rollout(make_step(cfg, u_bc, v_bc, p_bc), state0, cfg.nt)


class NavierStokesSystem:
    """Reference-API wrapper: holds ICs, BC lists (this package's BCs or
    any with the same fields) and physics constants; the fields live on
    `device` (default CUDA; core/device.py)."""

    def __init__(self, u_ic, v_ic, p_ic, u_bc, v_bc, p_bc,
                 nt=200, nit=50, nx=50, ny=50, dt=0.001, rho=1, nu=0.1,
                 dtype=torch.float32, device=None, pressure_mode="jacobi"):
        device = resolve_device(device)
        self.cfg = DirectFDConfig(nt=nt, nit=nit, nx=nx, ny=ny, dt=dt,
                                  rho=rho, nu=nu, pressure_mode=pressure_mode)
        self.u_bc, self.v_bc, self.p_bc = (bcs_from_reference(b)
                                           for b in (u_bc, v_bc, p_bc))
        as_field = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.state0 = FlowState(u=as_field(u_ic), v=as_field(v_ic),
                                p=as_field(p_ic))
        self._step = make_step(self.cfg, self.u_bc, self.v_bc, self.p_bc)

    def step(self, state: FlowState) -> FlowState:
        return self._step(state)

    def simulate(self):
        return rollout(self._step, self.state0, self.cfg.nt)
