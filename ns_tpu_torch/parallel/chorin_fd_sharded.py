"""Spatially sharded chorin_fd solver: halo exchange and an all-reduce
gated red-black SOR pressure iteration.

Port of `ns_tpu/parallel/chorin_fd_sharded.py`: the single-device solver
(`solvers/chorin_fd.py`) as an SPMD program. chorin_fd keeps axis 0 = x;
fields are sharded along their SECOND dimension (y columns) over one mesh
dim, so both ADI operators stay local:

  - predictor (semi_implicit): the Crank-Nicolson operators act along the
    unsharded x axis (the x-sweep and the quirk y-sweep both contract axis
    0), one local GEMM a sweep. The corrected rectangular y-sweep
    (quirk_compat=False, `S @ B^-T`) contracts the sharded axis and takes
    ONE all_gather a field.
  - advection, diffusion and correction stencils: x-differences are
    local; y-differences read 1-cell halos (`parallel/halo.py`).
  - pressure 'redblack': red-black SOR with a GLOBAL convergence gate:
    each sweep's max|p - p_prev| is all-reduced (max) over the shards, so
    every shard takes the same sweeps as the JAX while_loop, whose
    iterate sequence is the single-device solver's. The gate lives on the
    device: a sweep after the gate closed leaves p as it is, and the host
    reads the flag every `GATE_EVERY` sweeps to leave the loop (every rank
    reads the same all-reduced flag, so every rank leaves on the same
    sweep). Two halo exchanges a sweep (one a colour).
  - pressure 'dst' (and the 'helmholtz' predictor's solve): the direct
    DST solve of the same Dirichlet-frame system on the zero-padded
    full-grid bases, four local GEMMs and two all_to_all transposes a
    solve. The padded shapes differ from the single-device solve's, so
    the results agree to rounding, not bitwise.

As the JAX file computes its SOR in jnp (it refuses `use_pallas`), the
port computes it in plain torch on each rank's block: no kernel (the
port's config has no `use_pallas`: the single-device step picks its
kernels by grid).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.core.bc import BC
from ns_tpu_torch.core.state import FlowState, rollout
from ns_tpu_torch.ops.fast_poisson import _dst_basis
from ns_tpu_torch.ops.gemm import matmul
from ns_tpu_torch.parallel.collectives import (all_gather, all_reduce_max,
                                               all_to_all)
from ns_tpu_torch.parallel.direct_fd_sharded import _apply_bcs_block
from ns_tpu_torch.parallel.halo import exchange_halo_cols, is_first, is_last
from ns_tpu_torch.parallel.mesh import (GlobalArray, Sharding, axis_index,
                                        axis_size, mesh_device, shard, wrap)
from ns_tpu_torch.solvers.chorin_fd import ChorinFDConfig, _adi_inverses

# sweeps between the host's reads of the SOR gate's device flag
GATE_EVERY = 8


def make_sharded_step(cfg: ChorinFDConfig, u_bc: Sequence[BC],
                      v_bc: Sequence[BC], p_bc: Sequence[BC],
                      mesh: DeviceMesh, axis: str = "x",
                      dtype=torch.float32):
    """The sharded step on this rank (fields sharded along dim 1 on mesh
    dim `axis`). Returns (step, Sharding); step maps a FlowState of
    GlobalArrays (or of the rank's blocks) to the next one.

    Supports all three predictor methods (explicit, semi_implicit and the
    corrected unsplit-CN 'helmholtz', whose eigenbasis solve rides the
    same transposes as the dst pressure) and two pressure modes:
    'redblack' (the all-reduce gated SOR) and 'dst' (the distributed
    direct solve). ('gauss_seidel', 'cg', 'multigrid' and the kernels stay
    single-device paths.)"""
    if cfg.pressure_mode not in ("redblack", "dst"):
        raise ValueError("sharded chorin_fd supports pressure_mode="
                         "'redblack' or 'dst' only")
    n = axis_size(mesh, axis)
    if cfg.ny % n:
        raise ValueError(f"ny={cfg.ny} not divisible by mesh axis size {n}")
    by = cfg.ny // n
    if by < 2:
        raise ValueError("need at least 2 columns per shard")
    nx, ny = cfg.nx, cfg.ny
    dt, dx, dy, nu, rho = cfg.dt, cfg.dx, cfg.dy, cfg.nu, cfg.rho
    dx2, dy2 = dx * dx, dy * dy
    dev = mesh_device(mesh)
    i = axis_index(mesh, axis)
    owns = {"left": True, "right": True, "bottom": is_first(mesh, axis),
            "top": is_last(mesh, axis)}
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,  # noqa: E731
                                     device=dev)
    needs_dst = cfg.pressure_mode == "dst" or cfg.method == "helmholtz"
    if needs_dst:
        if nx % n:
            raise ValueError(f"the DST paths need nx={nx} divisible by "
                             f"mesh axis size {n} (all_to_all transpose)")
        Sx_h, lamx = _dst_basis(nx - 2, dx)
        Sy_h, lamy = _dst_basis(ny - 2, dy)
        Sx_pad = as_t(np.pad(Sx_h, 1))                       # (nx, nx)
        Sy_pad = as_t(np.pad(Sy_h, 1))                       # (ny, ny)
        lam_sum = lamx[:, None] + lamy[None, :]
        bx = nx // n

        def pad_inv_den(den_int):
            """1/den on the interior of the full grid, zeros on the ring;
            this rank's rows (its block after the first transpose)."""
            full = np.zeros((nx, ny))
            full[1:-1, 1:-1] = 1.0 / den_int
            return as_t(full[i * bx:(i + 1) * bx])

        if cfg.pressure_mode == "dst":
            inv_den_poisson = pad_inv_den(lam_sum)
        if cfg.method == "helmholtz":
            a_cn = dt * nu / 2.0
            inv_den_helm = pad_inv_den(1.0 - a_cn * lam_sum)
        prec = cfg.gemm_precision or "highest"
        mm = lambda a, b: matmul(a, b, prec)  # noqa: E731

        def dst_apply(F_block, inv_den_rows):
            """Padded-basis eigenbasis solve on a (nx, by) column block:
            Sx ((Sx F Sy) * inv_den) Sy with the sharded contractions on
            two all_to_all transposes."""
            t = mm(Sx_pad, F_block)                            # (nx, by)
            t = all_to_all(t, mesh, axis, split_dim=0, concat_dim=1)
            t = mm(t, Sy_pad)                                  # (bx, ny)
            t = t * inv_den_rows
            t = mm(t, Sy_pad)
            t = all_to_all(t, mesh, axis, split_dim=1, concat_dim=0)
            return mm(Sx_pad, t)                               # (nx, by)

    if cfg.method == "semi_implicit":
        A_inv, B_inv = _adi_inverses(cfg, dtype, dev)
        adi_mm = lambda a, b: matmul(a, b, cfg.gemm_precision)  # noqa: E731
        # corrected y-sweep: B^-T with zero columns at the global boundary
        # positions, this rank's columns of it, so the product of the
        # gathered (nx-2, ny-2) interior with them lands on the shard's
        # global column range (boundary columns come out zero)
        Bt_cols = F.pad(B_inv.T, (1, 1))[:, i * by:(i + 1) * by].contiguous()

    gi = torch.arange(nx, device=dev)[:, None]
    gj = torch.arange(by, device=dev)[None, :] + i * by
    interior = (gi > 0) & (gi < nx - 1) & (gj > 0) & (gj < ny - 1)
    red = ((gi + gj) % 2 == 0) & interior
    black = ((gi + gj) % 2 == 1) & interior
    first_col, last_col = gj == 1, gj == ny - 2

    def ypad(a):
        return exchange_halo_cols(a, mesh, axis)

    def ystencil(a):
        """(left j-1, right j+1) neighbour columns via the halo."""
        ap = ypad(a)
        return ap[:, :-2], ap[:, 2:]

    def pad_rows(a, like):
        """(nx-2, by) interior rows into an (nx, by) block, the rows of
        `like` outside the interior mask."""
        return torch.where(interior, F.pad(a, (0, 0, 1, 1)), like)

    def explicit(un, vn, un1, vn1):
        def adv_diff(f, f1):
            fL, fR = ystencil(f)
            f1L, f1R = ystencil(f1)
            f_dx = (f[2:] - f[:-2]) / (2.0 * dx)
            f1_dx = (f1[2:] - f1[:-2]) / (2.0 * dx)
            if cfg.quirk_compat:
                # the reference reuses the axis-0 difference for the y term
                f_dy = (f[2:] - f[:-2]) / (2.0 * dy)
                f1_dy = (f1[2:] - f1[:-2]) / (2.0 * dy)
            else:
                f_dy = ((fR - fL) / (2.0 * dy))[1:-1]
                f1_dy = ((f1R - f1L) / (2.0 * dy))[1:-1]
            lap_f = ((f[2:] - 2 * f[1:-1] + f[:-2]) / dx2
                     + ((fR - 2 * f + fL) / dy2)[1:-1])
            lap_f1 = ((f1[2:] - 2 * f1[1:-1] + f1[:-2]) / dx2
                      + ((f1R - 2 * f1 + f1L) / dy2)[1:-1])
            return f_dx, f_dy, f1_dx, f1_dy, lap_f, lap_f1

        u_dx, u_dy, u1_dx, u1_dy, lap_u, lap_u1 = adv_diff(un, un1)
        v_dx, v_dy, v1_dx, v1_dy, lap_v, lap_v1 = adv_diff(vn, vn1)
        uc, vc = un[1:-1], vn[1:-1]
        uc1, vc1 = un1[1:-1], vn1[1:-1]
        ui = (uc - dt * (1.5 * (uc * u_dx + vc * u_dy)
                         - 0.5 * (uc1 * u1_dx + vc1 * u1_dy))
              + dt * nu * (1.5 * lap_u - 0.5 * lap_u1))
        vi = (vc - dt * (1.5 * (uc * v_dx + vc * v_dy)
                         - 0.5 * (uc1 * v1_dx + vc1 * v1_dy))
              + dt * nu * (1.5 * lap_v - 0.5 * lap_v1))
        return pad_rows(ui, un), pad_rows(vi, vn)

    def helmholtz(un, vn, un1, vn1):
        """The corrected unsplit CN predictor on full (nx, by) blocks:
        stencils by rolls and halos, the boundary ring lifted onto the
        RHS, the eigenbasis solve by dst_apply. One halo exchange a field
        a step."""
        st_un, st_vn = ystencil(un), ystencil(vn)
        st_un1, st_vn1 = ystencil(un1), ystencil(vn1)

        def advect_full(f, g, h, h_st):
            hL, hR = h_st
            return (f * (torch.roll(h, -1, 0) - torch.roll(h, 1, 0))
                    / (2.0 * dx) + g * (hR - hL) / (2.0 * dy))

        def helm_solve(hn, Hn, Hn1, hn_st):
            hL, hR = hn_st
            lap_hn = ((torch.roll(hn, -1, 0) - 2 * hn
                       + torch.roll(hn, 1, 0)) / dx2
                      + (hR - 2 * hn + hL) / dy2)
            rhs = hn - dt * (1.5 * Hn - 0.5 * Hn1) + a_cn * lap_hn
            # ring lift: +a/h^2 times the fixed boundary neighbours
            rhs[1] += a_cn / dx2 * hn[0]
            rhs[-2] += a_cn / dx2 * hn[-1]
            rhs = (rhs + torch.where(first_col, a_cn / dy2 * hL, 0.0)
                   + torch.where(last_col, a_cn / dy2 * hR, 0.0))
            return torch.where(interior, dst_apply(rhs, inv_den_helm), hn)

        uHn = advect_full(un, vn, un, st_un)
        uHn1 = advect_full(un1, vn1, un1, st_un1)
        vHn = advect_full(un, vn, vn, st_vn)
        vHn1 = advect_full(un1, vn1, vn1, st_vn1)
        return (helm_solve(un, uHn, uHn1, st_un),
                helm_solve(vn, vHn, vHn1, st_vn))

    def semi_implicit(un, vn, un1, vn1):
        def advect(f, g, h):
            # f dh/dx + g dh/dy on interior rows, every local column
            hL, hR = ystencil(h)
            return (f[1:-1] * (h[2:] - h[:-2]) / (2.0 * dx)
                    + g[1:-1] * ((hR - hL) / (2.0 * dy))[1:-1])

        def lap(h):
            hL, hR = ystencil(h)
            return ((h[2:] - 2 * h[1:-1] + h[:-2]) / dx2
                    + ((hR - 2 * h + hL) / dy2)[1:-1])

        def sweeps(hn, hn1, Hn, Hn1):
            # x-sweep: contracts the local x axis; the quirk keeps the
            # reference's flipped advection sign
            sgn = 1.0 if cfg.quirk_compat else -1.0
            C1 = sgn * dt / 2.0 * (3.0 * Hn - Hn1)
            C2 = dt * nu * lap(hn)
            C = 2.0 / nu * dx2 * (C1 + C2)
            ht = adi_mm(A_inv, C)                   # (nx-2, by) local
            hL, hR = ystencil(hn)
            S = (2.0 / nu * dy2 * (ht + hn[1:-1])
                 - dt * ((hR - 2 * hn + hL)[1:-1]))
            if cfg.quirk_compat:
                # the reference's y-sweep contracts axis 0 too
                return adi_mm(B_inv, S)
            # corrected boundary lift on the wall-adjacent interior
            # columns, then the y-sweep over the gathered columns
            gji = gj.expand(nx, by)[1:-1]
            S = (S + torch.where(gji == 1, dt * hL[1:-1], 0.0)
                 + torch.where(gji == ny - 2, dt * hR[1:-1], 0.0))
            S_full = all_gather(S, mesh, axis, dim=1)   # (nx-2, ny)
            return adi_mm(S_full[:, 1:-1], Bt_cols)

        # every local column is computed (the halo gives the neighbours)
        # and the non-interior results are masked off
        uHn, uHn1 = advect(un, vn, un), advect(un1, vn1, un1)
        vHn, vHn1 = advect(un, vn, vn), advect(un1, vn1, vn1)
        return (pad_rows(sweeps(un, un1, uHn, uHn1), un),
                pad_rows(sweeps(vn, vn1, vHn, vHn1), vn))

    predictor = {"explicit": explicit, "helmholtz": helmholtz,
                 "semi_implicit": semi_implicit}[cfg.method]
    denom = 2.0 * (dx2 + dy2)

    def sor(p, rhs_c):
        """Red-black SOR to the all-reduced gate (the JAX while_loop: at
        most nit - 1 sweeps while max|p - p_prev| > sor_tol)."""
        def gs_update(p):
            pp = ypad(p)
            up, down = torch.roll(p, -1, 0), torch.roll(p, 1, 0)
            return (cfg.beta * (dy2 * (up + down) + dx2 * (pp[:, 2:]
                                                          + pp[:, :-2])
                                - rhs_c) / denom + (1.0 - cfg.beta) * p)

        open_ = torch.tensor(1.0 > cfg.sor_tol, device=p.device)
        for k in range(cfg.nit - 1):
            if k and k % GATE_EVERY == 0 and not bool(open_):
                break
            p_new = torch.where(red, gs_update(p), p)
            p_new = torch.where(black, gs_update(p_new), p_new)
            err = all_reduce_max((p_new - p).abs().max(), mesh, axis)
            p = torch.where(open_, p_new, p)
            open_ = open_ & (err > cfg.sor_tol)
        return p

    def dst_pressure(p, rhs_c):
        # lift the fixed boundary values onto the interior RHS; the padded
        # bases ignore the non-interior rows and columns of f
        f = rhs_c / (dx2 * dy2)
        inv_dx2, inv_dy2 = 1.0 / dx2, 1.0 / dy2
        f[1] += -p[0] * inv_dx2
        f[-2] += -p[-1] * inv_dx2
        pL, pR = ystencil(p)
        f = (f + torch.where(first_col, -pL * inv_dy2, 0.0)
             + torch.where(last_col, -pR * inv_dy2, 0.0))
        return torch.where(interior, dst_apply(f, inv_den_poisson), p)

    pressure = dst_pressure if cfg.pressure_mode == "dst" else sor

    def block_step(un, vn, un1, vn1, p):
        ui, vi = predictor(un, vn, un1, vn1)
        ui = _apply_bcs_block(ui, u_bc, owns)
        vi = _apply_bcs_block(vi, v_bc, owns)
        # backward differences: x by a local roll, y by the halo's left col
        vi_left = ypad(vi)[:, :-2]
        rhs_c = torch.where(
            interior,
            dx * rho * dy2 / dt * (ui - torch.roll(ui, 1, 0))
            + dy * rho * dx2 / dt * (vi - vi_left), 0.0)
        p = _apply_bcs_block(pressure(p, rhs_c), p_bc, owns)
        pL, pR = ystencil(p)
        u_new = ui - dt / (2.0 * dx) * (torch.roll(p, -1, 0)
                                        - torch.roll(p, 1, 0))
        v_new = vi - dt / (2.0 * dy) * (pR - pL)
        return (torch.where(interior, u_new, ui),
                torch.where(interior, v_new, vi), p, un, vn)

    sharding = Sharding(mesh, (None, axis))

    def step(state: FlowState) -> FlowState:
        fields = (state.u, state.v, state.u_prev, state.v_prev, state.p)
        blocks = [a.local if isinstance(a, GlobalArray) else a
                  for a in fields]
        out = block_step(*blocks)
        if isinstance(state.u, GlobalArray):
            out = [wrap(sharding, a) for a in out]
        u, v, p, u_prev, v_prev = out
        return FlowState(u=u, v=v, p=p, u_prev=u_prev, v_prev=v_prev)

    return step, sharding


def simulate(cfg: ChorinFDConfig, state0: FlowState, u_bc, v_bc, p_bc,
             mesh: DeviceMesh, axis: str = "x", dtype=torch.float32):
    """Sharded rollout returning the stacked (nt, nx, ny) u, v, p as
    GlobalArrays sharded on dim 2. state0 (with its AB history) holds the
    full fields, every rank the same, or this rank's GlobalArrays."""
    step, sharding = make_sharded_step(cfg, u_bc, v_bc, p_bc, mesh, axis,
                                       dtype)

    def block(a):
        local = a.local if isinstance(a, GlobalArray) else shard(sharding,
                                                                 a).local
        return local.to(dtype)

    state = FlowState(*(block(getattr(state0, f)) for f in
                        ("u", "v", "p", "u_prev", "v_prev")))
    out = Sharding(mesh, (None, None, axis))
    return tuple(wrap(out, s) for s in rollout(step, state, cfg.nt))
