"""Spatially sharded periodic spectral solver: transpose-based distributed
FFT.

Port of `ns_tpu/parallel/spectral_sharded.py`. Physical fields are
row-sharded over a mesh dim; each 2D transform is

    local rfft along y  ->  all_to_all transpose  ->  local fft along x

so the only traffic is one all_to_all a transform
(`parallel/collectives.py`, one `dist.all_to_all_single` on one
contiguous buffer), and every FFT runs on full local lines. Spectra live
column-sharded (ky chunks a rank); the spectral constants (1/k^2, i*k,
dealias, viscous factor) are each rank's chunk of the full tables.

The rfft half-spectrum width ny//2+1 is zero-padded up to a multiple of
the shard count for the all_to_all (`_padded_width`); the padded columns
carry zeros end to end. The compact matmul-DFT path runs the single-device
compact engine's GEMM stages (`make_compact_stages`: the dealias-truncated
DFT at the config's precision by `ops/gemm.py`'s rules, 'default' bf16
operands and fp32 sums, 'high'/'highest' fp32 and never TF32) with the
all_to_all between them, its ky width padded by `_compact_chunk_ops`.

Numerics are the single-device solver's (the same IF-AB2 step,
`solvers/spectral_periodic.py`). Each function runs on every rank of the
mesh (SPMD) on that rank's block: rollouts take and return
`parallel/mesh.py::GlobalArray`s.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.parallel.collectives import all_to_all
from ns_tpu_torch.parallel.mesh import (GlobalArray, Sharding, axis_index,
                                        axis_size, mesh_device, wrap)
from ns_tpu_torch.solvers.spectral_periodic import (
    SpectralPeriodicConfig, _derivative_factors, _forcing, _forcing_hat_np,
    _if_ab2, _ik_mul, _nonlinear_compact, make_compact_ops,
    make_compact_stages)


def _padded_width(cfg: SpectralPeriodicConfig, n_shards: int) -> int:
    nyh = cfg.ny // 2 + 1
    return ((nyh + n_shards - 1) // n_shards) * n_shards


def _host_constants(cfg: SpectralPeriodicConfig, n_shards: int):
    """Full-width padded spectral constants (host numpy), chunked per
    rank by `_make_fft_pieces`."""
    nyh = cfg.ny // 2 + 1
    nyp = _padded_width(cfg, n_shards)
    kx = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)[:, None]          # (nx, 1)
    ky = np.zeros((1, nyp))
    ky[0, :nyh] = np.fft.rfftfreq(cfg.ny, d=1.0 / cfg.ny)
    k2 = kx**2 + ky**2
    with np.errstate(divide="ignore"):
        inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    visc = np.exp(-cfg.nu * k2 * cfg.dt)
    mask_y = np.zeros(nyp, bool)
    if cfg.dealias:
        mask_x = np.abs(kx[:, 0]) < cfg.nx / 3.0
        mask_y[:nyh] = np.abs(
            np.fft.rfftfreq(cfg.ny, d=1.0 / cfg.ny)) < cfg.ny / 3.0
    else:
        mask_x = np.ones(cfg.nx, bool)
        mask_y[:nyh] = True
    mask = mask_x[:, None] & mask_y[None, :]
    out = dict(kx=kx, ky=ky, inv_k2=inv_k2, visc=visc, mask=mask, nyh=nyh,
               nyp=nyp)
    f_hat = _forcing_hat_np(cfg)
    if f_hat is not None:
        fp = np.zeros((cfg.nx, nyp), np.complex128)
        fp[:, :nyh] = f_hat                  # pad columns stay exact zeros
        out["f"] = fp
    return out


def _check_rows(cfg: SpectralPeriodicConfig, n: int) -> None:
    if cfg.nx % n:
        raise ValueError(f"nx={cfg.nx} not divisible by {n} shards")


def _make_fft_pieces(cfg: SpectralPeriodicConfig, mesh: DeviceMesh,
                     axis: str):
    """The distributed-FFT entry points' machinery on this rank:
    transposed transforms, the rank's constants, the masked nonlinear term
    and the IF-AB2 step."""
    n = axis_size(mesh, axis)
    _check_rows(cfg, n)
    C = _host_constants(cfg, n)
    nyh, nyp = C["nyh"], C["nyp"]
    cp = nyp // n          # spectral columns a rank
    i = axis_index(mesh, axis)
    dev, rdt = mesh_device(mesh), cfg.real_dtype
    chunk = lambda full: full[:, i * cp:(i + 1) * cp]  # noqa: E731
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=rdt,  # noqa: E731
                                  device=dev)
    c = dict(kx=t(C["kx"]), ky=t(chunk(C["ky"])),
             inv_k2=t(chunk(C["inv_k2"])), visc=t(chunk(C["visc"])),
             mask=torch.as_tensor(np.ascontiguousarray(chunk(C["mask"])),
                                  device=dev))
    if "f" in C:
        f = chunk(C["f"])
        c["f"] = torch.complex(t(f.real), t(f.imag))

    def fwd(w_local):
        """(bx, ny) real -> (nx, cp) complex column-sharded spectrum."""
        a = torch.fft.rfft(w_local, dim=1)                     # (bx, nyh)
        a = torch.nn.functional.pad(a, (0, nyp - nyh))         # (bx, nyp)
        a = all_to_all(a, mesh, axis, split_dim=1, concat_dim=0)  # (nx, cp)
        return torch.fft.fft(a, dim=0)

    def inv(s):
        """(nx, cp) complex -> (bx, ny) real."""
        a = torch.fft.ifft(s, dim=0)                           # (nx, cp)
        a = all_to_all(a, mesh, axis, split_dim=0, concat_dim=1)  # (bx, nyp)
        return torch.fft.irfft(a[:, :nyh], n=cfg.ny, dim=1)

    def nonlinear(w_hat):
        w_hat = torch.where(c["mask"], w_hat, 0.0)
        psi = w_hat * c["inv_k2"]
        u = inv(_ik_mul(c["ky"], psi))
        v = inv(-_ik_mul(c["kx"], psi))
        wx = inv(_ik_mul(c["kx"], w_hat))
        wy = inv(_ik_mul(c["ky"], w_hat))
        N = -fwd(u * wx + v * wy)
        if "f" in c:  # constant body forcing rides the advective RHS
            N = N + c["f"]
        return torch.where(c["mask"], N, 0.0)

    def step(carry):
        w_hat, N_prev = carry
        N = nonlinear(w_hat)
        E = c["visc"]
        w_new = E * w_hat + cfg.dt * (1.5 * E * N - 0.5 * E * E * N_prev)
        return (w_new, N), w_new

    return dict(fwd=fwd, inv=inv, nonlinear=nonlinear, step=step, consts=c)


def _local(w0, cfg: SpectralPeriodicConfig) -> torch.Tensor:
    """The rank's block of w0 (a GlobalArray, or the block itself)."""
    block = w0.local if isinstance(w0, GlobalArray) else w0
    return block.to(cfg.real_dtype)


def make_sharded_rollout(cfg: SpectralPeriodicConfig, mesh: DeviceMesh,
                         axis: str = "x"):
    """(rollout_fn, physical_sharding). rollout_fn maps a row-sharded
    physical vorticity (nx, ny) to the final row-sharded vorticity after
    cfg.nt IF-AB2 steps."""
    K = _make_fft_pieces(cfg, mesh, axis)
    sharding = Sharding(mesh, (axis, None))

    def rollout(w0: GlobalArray) -> GlobalArray:
        w_hat = K["fwd"](_local(w0, cfg))
        carry = (w_hat, K["nonlinear"](w_hat))
        for _ in range(cfg.nt):
            carry, _ = K["step"](carry)
        return wrap(sharding, K["inv"](carry[0]))

    return rollout, sharding


def make_sharded_simulate(cfg: SpectralPeriodicConfig, mesh: DeviceMesh,
                          axis: str = "x"):
    """(simulate, physical_sharding) for the distributed-FFT path:
    simulate maps row-sharded physical vorticity to the stacked
    (nt, nx, ny) vorticity rollout, row-sharded per frame."""
    K = _make_fft_pieces(cfg, mesh, axis)
    sharding = Sharding(mesh, (axis, None))

    def simulate(w0: GlobalArray) -> GlobalArray:
        w_hat = K["fwd"](_local(w0, cfg))
        carry = (w_hat, K["nonlinear"](w_hat))
        frames = []
        for _ in range(cfg.nt):
            carry, w_new = K["step"](carry)
            frames.append(K["inv"](w_new))
        return wrap(Sharding(mesh, (None, axis, None)), torch.stack(frames))

    return simulate, sharding


# ---------------------------------------------------------------------------
# Distributed compact matmul-DFT path
# ---------------------------------------------------------------------------
#
# The single-device compact engine (solvers/spectral_periodic.py,
# compact_spectrum: the dealias-truncated DFT as GEMMs) sharded over a
# mesh dim, on its own GEMM stages (`make_compact_stages`) with the
# all_to_all between the y and x stages. Layouts:
#
#   physical  (nx, ny)   row-sharded    -> (bx, ny) a rank
#   spectral  (Rx, kyc)  column-sharded -> (Rx, cp) a rank (ky chunks,
#                                          kyc zero-padded to n*cp)
#
# forward:  y_fwd (bx, ny) -> (bx, 2kyc) -> pad -> all_to_all
#           -> (nx, 2cp) -> x_fwd -> (Rx, cp)
# inverse:  x_inv (Rx, cp) -> (nx, 2cp) -> all_to_all -> (bx, 2kycp)
#           -> drop pad -> y_inv -> (bx, ny)
#
# (a ky column is an adjacent (re, im) pair between the stages), so each
# transform is the engine's two GEMMs and ONE all_to_all, and the nonlinear
# term and the IF-AB2 step are the engine's own (`_nonlinear_compact`,
# `_if_ab2`) on the rank's chunk of the compact constants: on a mesh of
# one rank the sharded rollout is the single-device one.


def _compact_chunk_ops(cfg: SpectralPeriodicConfig, n_shards: int, i: int,
                       device):
    """This rank's chunk of the compact constants (`make_compact_ops`,
    with `_nonlinear_compact`'s "d4" and "f_hat"), the ky width padded to
    kycp = a multiple of the shard count; the pad columns carry exact
    zeros, so padded modes stay zero through the whole rollout. Returns
    (ops, kyc, kycp)."""
    ops = make_compact_ops(cfg, device)
    kyc = ops["ky"].shape[-1]
    kycp = -(-kyc // n_shards) * n_shards
    cp = kycp // n_shards

    def chunk(a):
        a = torch.nn.functional.pad(a, (0, kycp - kyc))
        return a[:, i * cp:(i + 1) * cp].contiguous()

    ops = {k: v if k == "kx" else chunk(v) for k, v in ops.items()}
    ops["d4"] = _derivative_factors(ops)
    ops["f_hat"] = _forcing(ops)
    return ops, kyc, kycp


def make_sharded_compact(cfg: SpectralPeriodicConfig, mesh: DeviceMesh,
                         axis: str = "x"):
    """The sharded compact-DFT machinery on this rank: a dict of the pieces
    the rollout and simulate entry points below use (and tests): "ops"
    (the rank's constants), "fwd", "inv", "nonlinear" and "step".

    Requires cfg.transform='matmul' and cfg.dealias (the compact layout IS
    the 2/3-rule truncation)."""
    if cfg.transform != "matmul" or not cfg.dealias:
        raise ValueError("sharded compact path needs transform='matmul' "
                         "and dealias=True")
    n = axis_size(mesh, axis)
    _check_rows(cfg, n)
    dev = mesh_device(mesh)
    ops, kyc, kycp = _compact_chunk_ops(cfg, n, axis_index(mesh, axis), dev)
    y_fwd, x_fwd, x_inv, y_inv = make_compact_stages(cfg, dev)

    def fwd(w_local):
        """(..., bx, ny) real -> (..., Rx, cp) column-sharded spectrum."""
        t = torch.nn.functional.pad(y_fwd(w_local), (0, 2 * (kycp - kyc)))
        return x_fwd(all_to_all(t, mesh, axis, split_dim=-1,
                                concat_dim=-2))

    def inv(z):
        """(..., Rx, cp) -> (..., bx, ny) real; batched over leading dims
        (the four nonlinear-term transforms stack here)."""
        a = all_to_all(x_inv(z), mesh, axis, split_dim=-2, concat_dim=-1)
        return y_inv(a[..., :2 * kyc])

    def nonlinear(w_hat):
        return _nonlinear_compact(ops, fwd, inv, w_hat)

    return dict(ops=ops, fwd=fwd, inv=inv, nonlinear=nonlinear,
                step=_if_ab2(cfg, ops["visc"], nonlinear))


def make_sharded_compact_rollout(cfg: SpectralPeriodicConfig,
                                 mesh: DeviceMesh, axis: str = "x",
                                 ens_axis: Optional[str] = None):
    """(rollout, physical_sharding): rollout maps row-sharded physical
    vorticity (nx, ny) to the final row-sharded vorticity after cfg.nt
    compact IF-AB2 steps (the distributed rollout_final_compact).

    With `ens_axis`, the input carries a leading batch axis sharded
    data-parallel over that mesh dim: every transform GEMM gains a batch
    dim, the spatial all_to_all stays on the `axis` ranks, and the
    ensemble dim never communicates."""
    K = make_sharded_compact(cfg, mesh, axis)
    spec = (ens_axis, axis, None) if ens_axis else (axis, None)
    sharding = Sharding(mesh, spec)

    def rollout(w0: GlobalArray) -> GlobalArray:
        w_hat = K["fwd"](_local(w0, cfg))
        carry = (w_hat, K["nonlinear"](w_hat))
        for _ in range(cfg.nt):
            carry, _ = K["step"](carry)
        return wrap(sharding, K["inv"](carry[0]))

    return rollout, sharding


def make_sharded_compact_simulate(cfg: SpectralPeriodicConfig,
                                  mesh: DeviceMesh, axis: str = "x",
                                  fields: str = "w"):
    """(simulate, physical_sharding): simulate maps row-sharded physical
    vorticity to stacked rollouts: fields='w' returns the (nt, nx, ny)
    vorticity; fields='uvp' the (u, v, p) triple of (nt, nx, ny) arrays
    (the reference simulate() contract, the pressure by the spectral
    Poisson solve). Outputs stay row-sharded."""
    if fields not in ("w", "uvp"):
        raise ValueError("fields must be 'w'|'uvp'")
    K = make_sharded_compact(cfg, mesh, axis)
    rho = cfg.rho
    kx, ky_c, inv_k2_c = (K["ops"][k] for k in ("kx", "ky", "inv_k2"))
    out_sharding = Sharding(mesh, (None, axis, None))

    def out(w_hat):
        if fields == "w":
            return (K["inv"](w_hat),)
        psi = w_hat * inv_k2_c
        u_hat = _ik_mul(ky_c, psi)
        v_hat = -_ik_mul(kx, psi)
        u, v, ux, uy, vx, vy = K["inv"](torch.stack([
            u_hat, v_hat,
            _ik_mul(kx, u_hat), _ik_mul(ky_c, u_hat),
            _ik_mul(kx, v_hat), _ik_mul(ky_c, v_hat)]))
        rhs = -rho * (ux * ux + 2.0 * uy * vx + vy * vy)
        p = K["inv"](-K["fwd"](rhs) * inv_k2_c)
        return u, v, p

    def simulate(w0: GlobalArray):
        w_hat = K["fwd"](_local(w0, cfg))
        carry = (w_hat, K["nonlinear"](w_hat))
        seqs = []
        for _ in range(cfg.nt):
            carry, w_new = K["step"](carry)
            seqs.append(out(w_new))
        stacked = tuple(wrap(out_sharding, torch.stack(s))
                        for s in zip(*seqs))
        return stacked[0] if fields == "w" else stacked

    return simulate, Sharding(mesh, (axis, None))
