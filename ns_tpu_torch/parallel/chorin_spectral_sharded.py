"""Spatially sharded Chebyshev pseudospectral Chorin solver.

Port of `ns_tpu/parallel/chorin_spectral_sharded.py`: fields shard along
their SECOND dimension (y columns) over one mesh dim. The step is a chain
of dense operator applications; under column sharding they split into:

  - x-contractions (Dx, P, P_inv, DPx applied from the left): local GEMMs,
    no communication;
  - y-contractions (h @ M.T): one all_gather of the (rows, by) operand,
    then a local GEMM against this rank's column block of the
    zero-ring-padded operator (`_pad_right_mult`), so outputs stay
    column-sharded with the global boundary columns on the first and last
    rank;
  - the y-edge reconstruction: an all-reduced sum of each rank's partial
    sums.

Ten gathers and eight all-reduces a step (`tests/test_collectives.py`).
Only the CORRECTED mode (quirk_compat=False) and the dense eigen engine
are sharded, as in the JAX package: the reference-parity mode is a
single-device concern, and the parity engine's fold does not commute with
the column sharding. Every product runs through `ops/gemm.py::matmul` at
`cfg.matmul_precision`, as the JAX step traces under
`jax.default_matmul_precision`. The set-up is the single-device solver's
(`_setup`, `build_dense_eig`, `_add_dense_pressure_eig`). No Pallas kernel
lies on the JAX path, so no kernel here: cuBLAS GEMMs and torch ops.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.core.state import FlowState, rollout
from ns_tpu_torch.ops.gemm import matmul
from ns_tpu_torch.ops.parity import gemm_table
from ns_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
from ns_tpu_torch.parallel.mesh import (GlobalArray, Sharding, axis_index,
                                        axis_size, mesh_device, shard, wrap)
from ns_tpu_torch.solvers.chorin_spectral import (ChorinSpectralConfig,
                                                  _add_dense_pressure_eig,
                                                  _setup)


def _pad_right_mult(M_T: np.ndarray, ny: int, interior_in: bool
                    ) -> np.ndarray:
    """Zero-ring-pad a right-multiplier M.T to (ny, ny) so full-width
    column-sharded operands can contract it: rows pad when the operator
    consumes interior values only, columns always pad (outputs carry zero
    global-boundary columns, which the assembly masks or overwrites)."""
    src, _ = M_T.shape
    out = np.zeros((ny, ny))
    if interior_in:
        assert src == ny - 2
        out[1:-1, 1:-1] = M_T
    else:
        assert src == ny
        out[:, 1:-1] = M_T
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A device table's values on the host (float64 numpy)."""
    return t.detach().to("cpu", torch.float64).numpy()


def make_sharded_step(cfg: ChorinSpectralConfig, u_bc, v_bc,
                      mesh: DeviceMesh, axis: str = "x",
                      dtype=torch.float64):
    """The sharded corrected-mode step on this rank, on (nx, ny) fields
    sharded along dim 1. Returns (step, Sharding)."""
    if cfg.quirk_compat:
        raise ValueError(
            "sharded chorin_spectral runs the corrected mode only "
            "(quirk_compat=False); reference-parity runs are single-device")
    n = axis_size(mesh, axis)
    Nx, Ny = cfg.nx, cfg.ny
    if Ny % n:
        raise ValueError(f"ny={Ny} not divisible by mesh axis size {n}")
    by = Ny // n
    if by < 2:
        raise ValueError("need at least 2 columns per shard")
    dt, rho, nu = cfg.dt, cfg.rho, cfg.nu
    dt_eff = nu * dt  # the corrected mode applies the configured viscosity
    prec = cfg.matmul_precision
    mm = lambda a, b: matmul(a, b, prec)  # noqa: E731
    dev = mesh_device(mesh)
    lo, hi = axis_index(mesh, axis) * by, (axis_index(mesh, axis) + 1) * by

    # the dense eigen engine (the parity engine's fold and concat layout
    # does not commute with the column sharding)
    u_ops, v_ops, C, host = _setup(cfg, u_bc, v_bc, dtype, dev)
    same_ops = (np.array_equal(u_ops._Mx_np, v_ops._Mx_np)
                and np.array_equal(u_ops._My_np, v_ops._My_np))
    # with identical operators u's eigendecompositions solve both fields
    solved = (u_ops,) if same_ops else (u_ops, v_ops)
    for ops in solved:
        ops.build_dense_eig()
    _add_dense_pressure_eig(C, host, dtype, dev, prec)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,  # noqa: E731
                                     device=dev)
    table = lambda a: gemm_table(a, dtype, dev, prec)  # noqa: E731

    def cols(a):
        """This rank's columns of a host (..., Ny) array, on the device."""
        return as_t(a[..., lo:hi])

    def right_mult(M_T, interior_in):
        """This rank's column block of the padded right-multiplier."""
        return table(_pad_right_mult(M_T, Ny, interior_in)[:, lo:hi])

    def pad_cols(v):
        out = np.zeros((Ny,))
        out[1:-1] = v
        return out

    R_DyrT = right_mult(host["Dy_rows"].T, False)
    R_DPyT = right_mult(host["DPy"].T, True)
    R_pQinvT = right_mult(_host(C["p_Q_inv"]).T, True)
    R_pQT = right_mult(_host(C["p_Q"]).T, True)
    Dxr, DPx = table(host["Dx_rows"]), table(host["DPx"])

    def solve_consts(ops):
        """The Helmholtz solve's padded eigenbases and 1/denominator."""
        lamy = pad_cols(_host(ops.lamy))[None, :]
        d = 2.0 - dt_eff * _host(ops.lamx)[:, None] - dt_eff * lamy
        return dict(R_QinvT=right_mult(_host(ops.Q_inv).T, True),
                    R_QT=right_mult(_host(ops.Q).T, True),
                    inv_hd=cols(1.0 / d))      # (Nx-2, by), benign pads

    def field_consts(ops):
        k, g = ops.kx, ops.g
        return dict(
            **(solve_consts(ops) if ops in solved else {}),
            b0_y=as_t(pad_cols(_host(ops.b0_y))),
            bN_y=as_t(pad_cols(_host(ops.bN_y))),
            b0_y_cols=cols(pad_cols(_host(ops.b0_y))),
            bN_y_cols=cols(pad_cols(_host(ops.bN_y))),
            xN_num=k["cN_minus"] * g["g_minus_x"]
            + k["cN_plus"] * g["g_plus_x"])

    fc = {id(ops): field_consts(ops) for ops in (u_ops, v_ops)}

    # the Uzawa inverse denominator, deflated on the TRUE interior
    # denominators, then zero-padded
    pd = _host(C["p_lamx"])[:, None] + _host(C["p_lamy"])[None, :]
    if cfg.deflate_pressure_nullspace:
        keep = np.abs(pd) > 1e-8 * np.abs(pd).max()
        inv_pd_int = np.where(keep, 1.0 / np.where(keep, pd, 1.0), 0.0)
    else:
        inv_pd_int = 1.0 / pd
    inv_pd = np.zeros((Nx - 2, Ny))
    inv_pd[:, 1:-1] = inv_pd_int
    inv_pd = cols(inv_pd)
    Dx2c0, Dx2cN = C["Dx_sqr_c0"], C["Dx_sqr_cN"]
    Dy2c0 = cols(pad_cols(host["Dy_sqr_rows"][:, 0]))
    Dy2cN = cols(pad_cols(host["Dy_sqr_rows"][:, -1]))

    gj = torch.arange(lo, hi, device=dev)[None, :]
    first, last = gj == 0, gj == Ny - 1
    interior_c = (gj > 0) & (gj < Ny - 1)

    def gather(a):
        # the column axis is always the last one
        return all_gather(a, mesh, axis, dim=-1)

    def boundary_rows_x(soln, ops):
        """x0/xN edge-row values a local column (axis-0 sums, local)."""
        k = ops.kx
        x0 = ((ops.b0_x[:, None] * soln).sum(0) + ops.gx0_num) / k["e"]
        xN = ((ops.bN_x[:, None] * soln).sum(0) + fc[id(ops)]["xN_num"]) \
            / k["e"]
        return x0, xN

    def boundary_cols_y(soln, ops):
        """y0/yN edge-column values (all-reduced partial sums)."""
        w = fc[id(ops)]
        part0 = (w["b0_y_cols"][None, :] * soln).sum(1)
        partN = (w["bN_y_cols"][None, :] * soln).sum(1)
        y0 = all_reduce_sum(part0, mesh, axis) / ops.ky["e"] + ops.gy0
        yN = all_reduce_sum(partN, mesh, axis) / ops.ky["e"] + ops.gyN
        return y0, yN

    def assemble(soln, ops):
        """Interior-row (Nx-2, by) solution (zero boundary cols) -> full
        (Nx, by) field with reconstructed edges; corners stay zero."""
        x0, xN = boundary_rows_x(soln, ops)
        y0, yN = boundary_cols_y(soln, ops)
        out = soln.new_zeros((Nx, by))
        mid = torch.where(first, y0[:, None], soln)
        out[1:-1] = torch.where(last, yN[:, None], mid)
        out[0] = torch.where(interior_c[0], x0, 0.0)
        out[-1] = torch.where(interior_c[0], xN, 0.0)
        return out

    def block_step(un, vn, un1, vn1, p):
        un_g, vn_g = gather(un), gather(vn)
        un1_g, vn1_g = gather(un1), gather(vn1)
        _un, _vn = un[1:-1], vn[1:-1]
        _un1, _vn1 = un1[1:-1], vn1[1:-1]

        def F_of(h_loc, h_g, h1_loc, h1_g, ops):
            h_dx, h1_dx = mm(Dxr, h_loc), mm(Dxr, h1_loc)   # local
            h_dy = mm(h_g[1:-1], R_DyrT)                     # gathered
            h1_dy = mm(h1_g[1:-1], R_DyrT)
            hi_ = h_loc[1:-1]
            # CN diffusion folded into the Helmholtz solve: no D^2 GEMMs;
            # the boundary algebra below is rank-1
            F = (4.0 * hi_
                 - 3.0 * dt * (_un * h_dx + _vn * h_dy)
                 + dt * (_un1 * h1_dx + _vn1 * h1_dy))
            w = fc[id(ops)]
            cx0 = (h_loc[0] - mm(ops.b0_x[None, :], hi_)[0] / ops.kx["e"]
                   + ops.gx0)
            cxN = (h_loc[-1] - mm(ops.bN_x[None, :], hi_)[0] / ops.kx["e"]
                   + ops.gxN)
            # h_g is the whole field, so the global y-boundary sums are
            # local (the padded weights carry zeros on the boundary
            # columns): no all-reduce here
            sum0 = (w["b0_y"][None, :] * h_g[1:-1]).sum(1)
            sumN = (w["bN_y"][None, :] * h_g[1:-1]).sum(1)
            cy0 = h_g[1:-1, 0] - sum0 / ops.ky["e"] + ops.gy0
            cyN = h_g[1:-1, -1] - sumN / ops.ky["e"] + ops.gyN
            lift = (Dx2c0[:, None] * cx0[None, :]
                    + Dx2cN[:, None] * cxN[None, :]
                    + cy0[:, None] * Dy2c0[None, :]
                    + cyN[:, None] * Dy2cN[None, :])
            F = F + nu * dt * lift
            # the solve is interior-only: zero the global boundary columns
            return torch.where(interior_c, F, 0.0)

        def helmholtz(F, ops):
            w = fc[id(ops)]
            Ht = mm(ops.P_inv, F)                       # local
            u_hat = mm(gather(Ht), w["R_QinvT"]) * w["inv_hd"]
            return mm(ops.P, mm(gather(u_hat), w["R_QT"]))

        u_F = F_of(un, un_g, un1, un1_g, u_ops)
        v_F = F_of(vn, vn_g, vn1, vn1_g, v_ops)
        if same_ops:
            soln = helmholtz(torch.stack([u_F, v_F]), u_ops)
            u_soln, v_soln = soln[0], soln[1]
        else:
            u_soln, v_soln = helmholtz(u_F, u_ops), helmholtz(v_F, v_ops)
        # the 4h - (2-A)h identity solves for u* + h: subtract h's
        # interior, on interior global columns only
        u_soln = u_soln - torch.where(interior_c, _un, 0.0)
        v_soln = v_soln - torch.where(interior_c, _vn, 0.0)
        ui, vi = assemble(u_soln, u_ops), assemble(v_soln, v_ops)

        # correction: Uzawa + gradient projection
        H = rho / dt * (mm(Dxr, ui) + mm(gather(vi)[1:-1], R_DyrT))
        H = torch.where(interior_c, H, 0.0)
        Ht = mm(C["p_P_inv"], H)
        Q_hat = mm(gather(Ht), R_pQinvT) * inv_pd
        Q = mm(C["p_P"], mm(gather(Q_hat), R_pQT))     # bnd cols 0
        u_int = ui[1:-1] - mm(DPx, Q) * dt / rho
        v_int = vi[1:-1] - mm(gather(Q), R_DPyT) * dt / rho
        u_next = assemble(torch.where(interior_c, u_int, 0.0), u_ops)
        v_next = assemble(torch.where(interior_c, v_int, 0.0), v_ops)
        # p's boundary ring kept, as the single-device p[1:-1, 1:-1] = Q:
        # interior rows AND interior global columns take Q
        p_next = p.clone()
        p_next[1:-1] = torch.where(interior_c, Q, p[1:-1])
        return u_next, v_next, p_next, un, vn

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


def simulate(cfg: ChorinSpectralConfig, state0: FlowState, u_bc, v_bc,
             mesh: DeviceMesh, axis: str = "x", dtype=torch.float64):
    """Sharded corrected-mode rollout returning the stacked (nt, nx, ny)
    u, v, p as GlobalArrays sharded on dim 2. state0 (with its AB
    history) holds the full fields, every rank the same, or this rank's
    GlobalArrays."""
    step, sharding = make_sharded_step(cfg, u_bc, v_bc, mesh, axis, dtype)

    def block(a):
        local = a.local if isinstance(a, GlobalArray) else shard(sharding,
                                                                 a).local
        return local.to(dtype)

    state = FlowState(*(block(getattr(state0, f)) for f in
                        ("u", "v", "p", "u_prev", "v_prev")))
    out = Sharding(mesh, (None, None, axis))
    return tuple(wrap(out, s) for s in rollout(step, state, cfg.nt))
