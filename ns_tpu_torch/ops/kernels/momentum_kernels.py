"""Explicit-momentum kernel: wrapper of K3 (`csrc/momentum_kernels.cu`).

`momentum_explicit_fused` replaces
`ns_tpu/ops/pallas/momentum_kernels.py::momentum_explicit_fused_pallas`
(and its any-shape entry `momentum_explicit_fused_any`): the chorin_fd
explicit predictor (AB2 advection + AB2 diffusion of u and v) followed by
the u/v BC edge writes in list order. Its plain twin is `momentum_explicit`
below, the port of `ns_tpu/solvers/chorin_fd.py::_explicit_predictor`
followed by `apply_bcs`.

The kernel moves six grid streams for ~80 FLOPs a cell, 12-16 of them the
TPU expression's IEEE divisions, and is one launch a call: each block
stages its tile of the four inputs in
shared memory, 16 bytes a copy where the rows allow it, and writes 16-byte
vectors of u* and v*; the BC lists come as their edge plans
(`poisson_kernels.k2_edge_plan`), so the thread that owns an edge or corner
cell writes what the list leaves there, recomputing the interior cell a
Neumann edge reads (details in the CUDA source). The wrapper calls the
operator `torch.ops.ns_tpu.momentum_explicit_fused` (`library.py`) with
the two lists' edge plans: on a CPU tensor it runs the twin, on a CUDA
tensor it launches the kernel or raises.

Both take one (nx, ny) field of each or (B, nx, ny) batches of members
(the JAX package's FD ensemble gives the TPU kernel a member axis under
vmap): the kernel runs a batch in one launch, the members on the grid's
third axis (one launch per K3_MAX_MEMBERS members).
"""

from __future__ import annotations

import torch

from ns_tpu_torch.core.bc import apply_bcs
from ns_tpu_torch.ops.kernels import _build
from ns_tpu_torch.ops.kernels.poisson_kernels import (edge_plan, plan_bcs,
                                                      plan_spec)

# members one launch takes: the grid's third axis holds at most 65535 blocks
K3_MAX_MEMBERS = 65535


def momentum_explicit(un, vn, un1, vn1, dt: float, dx: float, dy: float,
                      nu: float, u_bc, v_bc, quirk_compat: bool = True):
    """Adams-Bashforth advection + diffusion, then the velocity BCs.

    Axis 0 carries x. With quirk_compat (default) the y-advection
    derivative of each field reuses the axis-0 difference, divided by 2*dy,
    exactly as the reference wrote it; otherwise the axis-1 difference is
    used. The grid is the last two axes: a leading member axis is a batch.
    """

    def adv_diff(f, f1):
        f_dx = (f[..., 2:, 1:-1] - f[..., :-2, 1:-1]) / (2.0 * dx)
        f1_dx = (f1[..., 2:, 1:-1] - f1[..., :-2, 1:-1]) / (2.0 * dx)
        if quirk_compat:
            f_dy = (f[..., 2:, 1:-1] - f[..., :-2, 1:-1]) / (2.0 * dy)
            f1_dy = (f1[..., 2:, 1:-1] - f1[..., :-2, 1:-1]) / (2.0 * dy)
        else:
            f_dy = (f[..., 1:-1, 2:] - f[..., 1:-1, :-2]) / (2.0 * dy)
            f1_dy = (f1[..., 1:-1, 2:] - f1[..., 1:-1, :-2]) / (2.0 * dy)
        lap_f = ((f[..., 2:, 1:-1] - 2 * f[..., 1:-1, 1:-1]
                  + f[..., :-2, 1:-1]) / dx**2
                 + (f[..., 1:-1, 2:] - 2 * f[..., 1:-1, 1:-1]
                    + f[..., 1:-1, :-2]) / dy**2)
        lap_f1 = ((f1[..., 2:, 1:-1] - 2 * f1[..., 1:-1, 1:-1]
                   + f1[..., :-2, 1:-1]) / dx**2
                  + (f1[..., 1:-1, 2:] - 2 * f1[..., 1:-1, 1:-1]
                     + f1[..., 1:-1, :-2]) / dy**2)
        return f_dx, f_dy, f1_dx, f1_dy, lap_f, lap_f1

    u_dx, u_dy, u1_dx, u1_dy, lap_u, lap_u1 = adv_diff(un, un1)
    v_dx, v_dy, v1_dx, v1_dy, lap_v, lap_v1 = adv_diff(vn, vn1)
    uc, vc = un[..., 1:-1, 1:-1], vn[..., 1:-1, 1:-1]
    uc1, vc1 = un1[..., 1:-1, 1:-1], vn1[..., 1:-1, 1:-1]

    ui = un.clone()
    vi = vn.clone()
    ui[..., 1:-1, 1:-1] = uc - dt * (1.5 * (uc * u_dx + vc * u_dy)
                                     - 0.5 * (uc1 * u1_dx + vc1 * u1_dy)) \
        + dt * nu * (1.5 * lap_u - 0.5 * lap_u1)
    vi[..., 1:-1, 1:-1] = vc - dt * (1.5 * (uc * v_dx + vc * v_dy)
                                     - 0.5 * (uc1 * v1_dx + vc1 * v1_dy)) \
        + dt * nu * (1.5 * lap_v - 0.5 * lap_v1)
    return apply_bcs(ui, u_bc), apply_bcs(vi, v_bc)


def momentum_explicit_fused(un, vn, un1, vn1, dt: float, dx: float,
                            dy: float, nu: float, u_bc, v_bc,
                            quirk_compat: bool = True):
    """(u*, v*) = AB2 advection + diffusion + velocity BCs (K3): one
    launch, any grid shape, the BC lists applied as their edge plans. A
    (B, nx, ny) batch is one launch, the members on the grid's third
    axis."""
    return torch.ops.ns_tpu.momentum_explicit_fused.default(
        un, vn, un1, vn1, float(dt), float(dx), float(dy), float(nu),
        edge_plan(tuple(u_bc)), edge_plan(tuple(v_bc)), bool(quirk_compat))


def _momentum_cpu(un, vn, un1, vn1, dt, dx, dy, nu, u_plan, v_plan,
                  quirk_compat):
    return momentum_explicit(un, vn, un1, vn1, dt, dx, dy, nu,
                             plan_bcs(tuple(u_plan)),
                             plan_bcs(tuple(v_plan)), quirk_compat)


def _momentum_cuda(un, vn, un1, vn1, dt, dx, dy, nu, u_plan, v_plan,
                   quirk_compat):
    n, nx, ny = _build.check_inputs("momentum_explicit_fused", un, vn, un1,
                                    vn1, members=True)
    uo, vo = torch.empty_like(un), torch.empty_like(vn)
    # the C entry reads u's 12 doubles, then v's
    spec = plan_spec((*u_plan, *v_plan))
    fn = _build.entry("ns_momentum_explicit", un.dtype)
    with torch.cuda.device(un.device):
        code = fn(un.data_ptr(), vn.data_ptr(), un1.data_ptr(),
                  vn1.data_ptr(), uo.data_ptr(), vo.data_ptr(), nx, ny,
                  float(dt), dt * nu, 2.0 * dx, 2.0 * dy, dx**2, dy**2,
                  int(bool(quirk_compat)), spec, n, nx * ny,
                  _build.stream(un.device))
    _build.check(code, "momentum_explicit_fused")
    momentum_explicit_fused.launches += -(-n // K3_MAX_MEMBERS)
    momentum_explicit_fused.calls += 1
    return uo, vo


momentum_explicit_fused.launches = 0
momentum_explicit_fused.calls = 0
