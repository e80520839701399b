"""Pencil-sharded 3D periodic spectral solver: transpose-based distributed
transforms.

Port of `ns_tpu/parallel/spectral3d_sharded.py`, the scale-out path of the
3D family (`solvers/spectral3d.py`): a 1024^3 velocity state does not fit
one device, so the mesh is what makes such a grid run. The decomposition,
on the compact matmul-DFT layout (every local stage a GEMM):

    physical  (3, nx, ny, nz)   x-sharded  -> (3, bx, ny, nz) a rank
    spectral  (3, Rx, Ry, Kzc)  ky-sharded -> (3, Rx, cp, Kzc) a rank

    forward:  local z and y GEMMs -> pad Ry to Ryp -> all_to_all
              (ky chunks out, x rows in) -> local x GEMM
    inverse:  local x GEMM -> all_to_all -> drop the pad -> local y and z
              GEMMs (real part)

so each 3D transform costs ONE all_to_all: the six inverse transforms of
the nonlinear term (u, omega) ride one batched call, the three forward
transforms of the Lamb vector another. The local stages are the plain
compact route's own (`transform3d_kernels.zy_forward` / `yz_inverse`, the
twins of K6/K7, and `solvers/spectral3d.py::_x_stage`), so on a mesh of
one rank the sharded rollout is the single-device plain compact route
(fused off). An optional ensemble mesh dim batches independent rollouts
over a LEADING axis that never communicates.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.ops.kernels import transform3d_kernels as t3k
from ns_tpu_torch.parallel.collectives import all_to_all
from ns_tpu_torch.parallel.mesh import (GlobalArray, Sharding, axis_index,
                                        axis_size, mesh_device, wrap)
from ns_tpu_torch.solvers.spectral3d import (Spectral3DConfig, _compact_meta,
                                             _dft_constants_np,
                                             _forcing_hat_np, _ik_mul,
                                             _x_stage)


def _padded_chunks(n_rows: int, n_shards: int) -> int:
    return ((n_rows + n_shards - 1) // n_shards) * n_shards


def _host_constants(cfg: Spectral3DConfig, n_shards: int) -> dict:
    """Spectral constants on the ky-padded compact layout (Rx, Ryp, Kzc),
    host numpy; pad rows carry exact zeros in inv_k2 and visc, so padded
    modes stay zero through the rollout."""
    rows_x, rows_y, kzc = _compact_meta(cfg)
    Ry = len(rows_y)
    Ryp = _padded_chunks(Ry, n_shards)
    kx = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)[rows_x][:, None, None]
    ky = np.zeros((1, Ryp, 1))
    ky[0, :Ry, 0] = np.fft.fftfreq(cfg.ny, d=1.0 / cfg.ny)[rows_y]
    kz = np.fft.rfftfreq(cfg.nz, d=1.0 / cfg.nz)[:kzc][None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    visc = np.exp(-cfg.nu * k2 * cfg.dt)
    pad = np.arange(Ryp)[None, :, None] >= Ry
    out = dict(kx=kx, ky=ky, kz=kz, inv_k2=np.where(pad, 0.0, inv_k2),
               visc=np.where(pad, 0.0, visc),
               # the mean mode (pinned in the nonlinear term): k2 == 0 at
               # the origin and on pad rows, which are zero anyway
               origin=k2 == 0.0, Ry=Ry, Ryp=Ryp)
    f_hat = _forcing_hat_np(cfg)  # (3, Rx, Ry, kzc), compact layout
    if f_hat is not None:
        fp = np.zeros((3, len(rows_x), Ryp, kzc), np.complex128)
        fp[:, :, :Ry, :] = f_hat             # pad rows stay exact zeros
        out["f"] = fp
    return out


def make_sharded_compact3d(cfg: Spectral3DConfig, mesh: DeviceMesh,
                           axis: str = "x") -> dict:
    """The sharded 3D compact-DFT machinery on this rank: transposed
    transforms, this rank's chunk of the constants, the projected
    nonlinear term and the IF-AB2 step. Requires transform='matmul' (the
    compact layout IS the 2/3 truncation)."""
    if not cfg.compact:
        raise ValueError("sharded 3D path needs transform='matmul' "
                         "(compact dealias-truncated layout)")
    n = axis_size(mesh, axis)
    if cfg.nx % n:
        raise ValueError(f"nx={cfg.nx} not divisible by {n} shards")
    dev, rdt = mesh_device(mesh), cfg.real_dtype
    M = {k: torch.as_tensor(v, dtype=cfg.complex_dtype, device=dev)
         for k, v in _dft_constants_np(cfg).items()}
    C = _host_constants(cfg, n)
    Ry, Ryp = C["Ry"], C["Ryp"]
    cp = Ryp // n
    i = axis_index(mesh, axis)
    prec = cfg.matmul_precision

    def chunk(a):
        """This rank's ky chunk of a (..., Rx|1, Ryp, Kzc|1) constant."""
        return np.ascontiguousarray(a[..., i * cp:(i + 1) * cp, :])

    t = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)  # noqa: E731
    c = dict(kx=t(C["kx"]), kz=t(C["kz"]), ky=t(chunk(C["ky"])),
             inv_k2=t(chunk(C["inv_k2"])), visc=t(chunk(C["visc"])),
             origin=torch.as_tensor(chunk(C["origin"]), device=dev))
    if "f" in C:
        f = chunk(C["f"])
        c["f"] = torch.complex(t(f.real), t(f.imag))

    def fwd(w_local):
        """(..., bx, ny, nz) real -> (..., Rx, cp, Kzc) ky-sharded."""
        a = t3k.zy_forward(w_local.to(rdt).contiguous(), M["Fz_t"],
                           M["Fy_t"], precision=prec)        # (.., bx, Ry, K)
        a = F.pad(a, (0, 0, 0, Ryp - Ry))
        a = all_to_all(a, mesh, axis, split_dim=-2, concat_dim=-3)
        return _x_stage(M["Fx_t"], a, prec)

    def inv(z):
        """(..., Rx, cp, Kzc) -> (..., bx, ny, nz) real, batched over the
        leading dims (the six nonlinear-term transforms stack here)."""
        a = _x_stage(M["Fxi_t"], z, prec)                    # (.., nx, cp, K)
        a = all_to_all(a, mesh, axis, split_dim=-3, concat_dim=-2)
        return t3k.yz_inverse(a[..., :Ry, :].contiguous(), M["Fyi_t"],
                              M["Bz"], cfg.nz, precision=prec)

    # component access at dim -4: the spectra may carry LEADING batch dims
    # (the ensemble axis)
    comp = lambda a, j: a[..., j, :, :, :]  # noqa: E731
    stk = lambda xs: torch.stack(xs, dim=-4)  # noqa: E731

    def project(v_hat):
        """Leray projection on the chunked layout, batch-safe."""
        kx, ky, kz = c["kx"], c["ky"], c["kz"]
        kdot = (kx * comp(v_hat, 0) + ky * comp(v_hat, 1)
                + kz * comp(v_hat, 2))
        corr = kdot * c["inv_k2"]
        return stk([comp(v_hat, 0) - kx * corr,
                    comp(v_hat, 1) - ky * corr,
                    comp(v_hat, 2) - kz * corr])

    def nonlinear(u_hat):
        """P[FFT(u x omega)] (+ f) on the chunked layout: one batched
        inverse all_to_all for the six fields, one forward for the three
        Lamb components."""
        kx, ky, kz = c["kx"], c["ky"], c["kz"]
        ux, uy, uz = (comp(u_hat, j) for j in range(3))
        wx = _ik_mul(ky, uz) - _ik_mul(kz, uy)
        wy = _ik_mul(kz, ux) - _ik_mul(kx, uz)
        wz = _ik_mul(kx, uy) - _ik_mul(ky, ux)
        u1, u2, u3, w1, w2, w3 = (comp(f, 0) for f in inv(
            torch.cat([u_hat, stk([wx, wy, wz])], dim=-4)).split(1, -4))
        lamb = stk([u2 * w3 - u3 * w2, u3 * w1 - u1 * w3,
                    u1 * w2 - u2 * w1])
        N = project(fwd(lamb))
        N = torch.where(c["origin"], 0.0, N)   # pin the mean mode
        if "f" in c:
            N = N + c["f"]
        return N

    def step(carry):
        u_hat, N_prev = carry
        N = nonlinear(u_hat)
        E = c["visc"]
        u_new = E * u_hat + cfg.dt * (1.5 * E * N - 0.5 * (E * E) * N_prev)
        return (u_new, N), u_new

    return dict(fwd=fwd, inv=inv, consts=c, nonlinear=nonlinear, step=step,
                project=project, cp=cp)


def _initial_carry(K: dict, cfg: Spectral3DConfig, u0):
    """The projected IC spectrum and its first nonlinear term (the
    unsharded carry builder)."""
    local = u0.local if isinstance(u0, GlobalArray) else u0
    u_hat = K["project"](K["fwd"](local.to(cfg.real_dtype)))
    return u_hat, K["nonlinear"](u_hat)


def make_sharded_rollout3d(cfg: Spectral3DConfig, mesh: DeviceMesh,
                           axis: str = "x",
                           ens_axis: Optional[str] = None):
    """(rollout, physical_sharding): rollout maps an x-sharded physical
    velocity (3, nx, ny, nz) to the x-sharded velocity after cfg.nt
    IF-AB2 steps (the distributed rollout_final + fields_from_hat).

    With `ens_axis`, the input gains a LEADING batch axis sharded over that
    mesh dim: the all_to_all stays on the `axis` ranks, and the ensemble
    axis never communicates."""
    K = make_sharded_compact3d(cfg, mesh, axis)
    spec = ((ens_axis, None, axis, None, None) if ens_axis
            else (None, axis, None, None))
    sharding = Sharding(mesh, spec)

    def rollout(u0) -> GlobalArray:
        carry = _initial_carry(K, cfg, u0)
        for _ in range(cfg.nt):
            carry, _ = K["step"](carry)
        return wrap(sharding, K["inv"](carry[0]))

    return rollout, sharding


def make_sharded_simulate3d(cfg: Spectral3DConfig, mesh: DeviceMesh,
                            axis: str = "x"):
    """(simulate, physical_sharding): an x-sharded physical velocity ->
    the STACKED (nt, 3, nx, ny, nz) velocity rollout, x-sharded a frame
    (the validation contract; long horizons take make_sharded_rollout3d,
    as this one holds every frame)."""
    K = make_sharded_compact3d(cfg, mesh, axis)
    out = Sharding(mesh, (None, None, axis, None, None))

    def simulate(u0) -> GlobalArray:
        carry = _initial_carry(K, cfg, u0)
        frames = None
        for n in range(cfg.nt):
            carry, u_new = K["step"](carry)
            frame = K["inv"](u_new)
            if frames is None:
                frames = frame.new_empty((cfg.nt, *frame.shape))
            frames[n] = frame
        return wrap(out, frames)

    return simulate, Sharding(mesh, (None, axis, None, None))
