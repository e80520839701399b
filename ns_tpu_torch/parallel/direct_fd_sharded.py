"""Spatially sharded direct_fd solver: halo exchange over one or two mesh
dims.

Port of `ns_tpu/parallel/direct_fd_sharded.py`: the single-device solver
(`solvers/direct_fd.py`) as an SPMD program. Fields are sharded over one
('x' rows) or two ('x' rows x 'y' columns) mesh dims; every stencil
neighbour across a shard boundary comes from a 1-cell halo exchange
(`parallel/halo.py`), and BC edge writes happen only on the ranks that own
the physical boundary. The Jacobi sweeps exchange halos once a sweep a
sharded axis: the dominant communication. With pressure_mode='exact' (1D
row decomposition only, as in the JAX package) the sweeps are replaced by
the direct mixed-BC eigenbasis solve: four local GEMMs and two all_to_all
transposes a step.

Numerics are the single-device algorithm's (the same update expressions).
As the JAX file computes its sweeps in jnp, outside any Pallas kernel, the
port computes them in plain torch on each rank's block (no kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.core.bc import BC, _apply_in_place
from ns_tpu_torch.core.state import FlowState, rollout
from ns_tpu_torch.ops.fast_poisson import _mixed_axis_operator, _side_bcs
from ns_tpu_torch.ops.gemm import matmul
from ns_tpu_torch.parallel.collectives import all_to_all
from ns_tpu_torch.parallel.halo import (exchange_halo_cols,
                                        exchange_halo_rows, is_first,
                                        is_last)
from ns_tpu_torch.parallel.mesh import (GlobalArray, Sharding, axis_index,
                                        axis_size, shard, wrap)
from ns_tpu_torch.solvers.direct_fd import DirectFDConfig


def _apply_bcs_block(a: torch.Tensor, bcs: Sequence[BC], owns: dict):
    """BCs on a sharded local block, in list order, with the reference's
    edge semantics: 'left'/'right' are global rows 0 / nx-1 (the first/last
    row shard), 'bottom'/'top' global cols 0 / ny-1 (the first/last col
    shard); `owns` says which edges this rank holds. A new tensor."""
    out = a.clone()
    for bc in bcs:
        if owns[bc.side]:
            _apply_in_place(out, bc)
    return out


def make_sharded_step(cfg: DirectFDConfig, u_bc, v_bc, p_bc,
                      mesh: DeviceMesh, axis: str = "x",
                      axis_y: Optional[str] = None):
    """The sharded step on this rank. `axis` shards rows; `axis_y`
    (optional) shards columns too (2D decomposition). Returns (step,
    Sharding); step maps a FlowState of GlobalArrays (or of the rank's
    blocks) to the next one."""
    ax_r, ax_c = axis, axis_y
    n_r = axis_size(mesh, ax_r)
    n_c = axis_size(mesh, ax_c) if ax_c else 1
    if cfg.nx % n_r or cfg.ny % n_c:
        raise ValueError(f"grid {cfg.nx}x{cfg.ny} not divisible by mesh "
                         f"{n_r}x{n_c}")
    bx, by = cfg.nx // n_r, cfg.ny // n_c
    if bx < 2 or by < 2:
        raise ValueError("need at least 2 rows and columns per shard")
    dt, dx, dy = cfg.dt, cfg.dx, cfg.dy
    rho, nu = cfg.rho, cfg.nu
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 * (dx2 + dy2)
    i_r = axis_index(mesh, ax_r)
    i_c = axis_index(mesh, ax_c) if ax_c else 0
    owns = {"left": is_first(mesh, ax_r), "right": is_last(mesh, ax_r),
            "bottom": is_first(mesh, ax_c) if ax_c else True,
            "top": is_last(mesh, ax_c) if ax_c else True}
    if cfg.pressure_mode == "exact":
        if ax_c is not None:
            raise ValueError("sharded pressure_mode='exact' supports the "
                             "1D row decomposition only (the eigenbasis "
                             "transposes assume one sharded axis)")
        if cfg.ny % n_r:
            raise ValueError(f"pressure_mode='exact' needs ny={cfg.ny} "
                             f"divisible by mesh axis size {n_r} "
                             "(all_to_all transpose)")
        eff = _side_bcs(p_bc)
        # axis 0 carries the y-differences: h0=dy, h1=dx
        V0_h, lam0, lift0 = _mixed_axis_operator(cfg.nx, dy, eff["left"],
                                                 eff["right"])
        V1_h, lam1, lift1 = _mixed_axis_operator(cfg.ny, dx, eff["bottom"],
                                                 eff["top"])
        den = lam0[:, None] + lam1[None, :]
        tiny = np.abs(den) < 1e-12 * max(1.0 / dy**2, 1.0 / dx**2)
        inv_den_h = np.where(tiny, 0.0, 1.0 / np.where(tiny, 1.0, den))
        inv_den_full = np.zeros((cfg.nx, cfg.ny))
        inv_den_full[1:-1, 1:-1] = inv_den_h
        lift_full = np.zeros((cfg.nx, cfg.ny))
        lift_full[1:-1, 1:-1] = lift0[:, None] + lift1[None, :]
        cy = cfg.ny // n_r
        exact = dict(V0=np.pad(V0_h, 1), V1=np.pad(V1_h, 1),
                     inv_den=inv_den_full[:, i_r * cy:(i_r + 1) * cy],
                     lift=lift_full[i_r * bx:(i_r + 1) * bx])
        tables: dict = {}

    def table(name, like):
        """An exact-mode table in the fields' dtype and device, made once."""
        key = (name, like.dtype, like.device)
        if key not in tables:
            a = exact[name[:-2]].T if name.endswith("_T") else exact[name]
            tables[key] = torch.as_tensor(np.ascontiguousarray(a),
                                          dtype=like.dtype, device=like.device)
        return tables[key]

    masks: dict = {}

    def interior_mask(like):
        key = (like.device,)
        if key not in masks:
            gi = torch.arange(bx, device=like.device)[:, None] + i_r * bx
            gj = torch.arange(by, device=like.device)[None, :] + i_c * by
            masks[key] = ((gi > 0) & (gi < cfg.nx - 1)
                          & (gj > 0) & (gj < cfg.ny - 1))
        return masks[key]

    def bcs(a, bc_list):
        return _apply_bcs_block(a, bc_list, owns)

    def pad_cols(a):
        if ax_c is None:
            # unsharded columns: wrap-pad; wrap cells are masked off
            return torch.cat([a[:, -1:], a, a[:, :1]], dim=1)
        return exchange_halo_cols(a, mesh, ax_c)

    def nbrs(a):
        """(left j-1, right j+1, down i-1, up i+1) neighbour blocks."""
        pr = exchange_halo_rows(a, mesh, ax_r)
        pc = pad_cols(a)
        return pc[:, :-2], pc[:, 2:], pr[:-2], pr[2:]

    def block_step(u, v, p):
        mask = interior_mask(u)

        # --- source term b (x along axis 1, y along axis 0) -------------
        uL, uR, uD, uU = nbrs(u)
        vL, vR, vD, vU = nbrs(v)
        dudx = (uR - uL) / (2 * dx)
        dvdx = (vR - vL) / (2 * dx)
        dudy = (uU - uD) / (2 * dy)
        dvdy = (vU - vD) / (2 * dy)
        b = torch.where(
            mask,
            rho / dt * (dudx + dvdy) - dudx**2 - 2 * dudy * dvdx - dvdy**2,
            0.0)

        # --- pressure ---------------------------------------------------
        if cfg.pressure_mode == "exact":
            # the direct mixed-BC eigenbasis solve distributed over the
            # rows: the axis-1 contractions are local on row blocks, the
            # axis-0 ones ride two all_to_all transposes. V0/V1 are
            # orthonormal (not symmetric): orientation matters.
            f = b + table("lift", p)                          # (bx, ny)
            t = matmul(f, table("V1", p), "highest")
            t = all_to_all(t, mesh, ax_r, split_dim=1, concat_dim=0)
            t = matmul(table("V0_T", p), t, "highest")        # (nx, cy)
            t = t * table("inv_den", p)
            t = matmul(table("V0", p), t, "highest")
            t = all_to_all(t, mesh, ax_r, split_dim=0, concat_dim=1)
            P = matmul(t, table("V1_T", p), "highest")        # (bx, ny)
            p = bcs(torch.where(mask, P, 0.0), p_bc)
        else:
            for _ in range(cfg.nit):
                pL, pR, pD, pU = nbrs(p)
                p_new = (((pR + pL) * dy2 + (pU + pD) * dx2) / denom
                         - dx2 * dy2 / denom * b)
                p = bcs(torch.where(mask, p_new, p), p_bc)

        # --- momentum ---------------------------------------------------
        pL, pR, pD, pU = nbrs(p)
        u_new = (u
                 - u * dt / dx * (u - uL)
                 - v * dt / dy * (u - uD)
                 - dt / (2 * rho * dx) * (pR - pL)
                 + nu * (dt / dx2 * (uR - 2 * u + uL)
                         + dt / dy2 * (uU - 2 * u + uD)))
        v_new = (v
                 - u * dt / dx * (v - vL)
                 - v * dt / dy * (v - vD)
                 - dt / (2 * rho * dy) * (pU - pD)
                 + nu * (dt / dx2 * (vR - 2 * v + vL)
                         + dt / dy2 * (vU - 2 * v + vD)))
        u = bcs(torch.where(mask, u_new, u), u_bc)
        v = bcs(torch.where(mask, v_new, v), v_bc)
        return u, v, p

    sharding = Sharding(mesh, (ax_r, ax_c))

    def step(state: FlowState) -> FlowState:
        blocks = [a.local if isinstance(a, GlobalArray) else a
                  for a in (state.u, state.v, state.p)]
        u, v, p = block_step(*blocks)
        if isinstance(state.u, GlobalArray):
            u, v, p = (wrap(sharding, a) for a in (u, v, p))
        return FlowState(u=u, v=v, p=p)

    return step, sharding


def simulate(cfg: DirectFDConfig, state0: FlowState, u_bc, v_bc, p_bc,
             mesh: DeviceMesh, axis: str = "x", axis_y: Optional[str] = None):
    """Sharded rollout returning the stacked (nt, nx, ny) u, v, p as
    GlobalArrays sharded on their grid dims. state0 holds the full fields
    (every rank the same) or this rank's GlobalArrays."""
    step, sharding = make_sharded_step(cfg, u_bc, v_bc, p_bc, mesh, axis,
                                       axis_y)

    def block(a):
        return a.local if isinstance(a, GlobalArray) else shard(sharding,
                                                                a).local

    state = FlowState(*(block(a) for a in (state0.u, state0.v, state0.p)))
    u_seq, v_seq, p_seq = rollout(step, state, cfg.nt)
    out = Sharding(mesh, (None, axis, axis_y))
    return tuple(wrap(out, s) for s in (u_seq, v_seq, p_seq))
