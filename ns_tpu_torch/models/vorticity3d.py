"""Divergence-free representations of 3D periodic flow: vorticity and the
Coulomb-gauge vector potential.

Port of `ns_tpu/models/vorticity3d.py`. For periodic incompressible 3D flow
the vorticity omega = curl(u) determines the zero-mean (u, v, w, p) state
exactly through the spectral Biot-Savart inversion

    u_hat = i k x omega_hat / |k|^2,

and so does the vector potential A (A_hat = i k x u_hat / |k|^2, u = curl
A). A surrogate that predicts either models three channels (p is
diagnostic) and recovers a velocity that is divergence-free for any
prediction: k . (k x a) = 0 on the paired modes, and the 2/3-band mask
removes the unpaired Nyquist planes where the identity fails.

The tables are the 3D solver's (`solvers/spectral3d.py`: 2*pi-periodic
box, integer wavenumbers, rfftn layout; the numpy helpers `_wavenumbers_np`
and `_dealias_mask_np` are copies of the JAX module's). Every function
takes leading batch axes (the JAX package's recoveries are per sample and
`vmap`ped) and computes in the input's dtype on its device; the tables are
cached per shape, dtype and device. Spectra that i*k or a learned map make
non-Hermitian are inverted by `spectral3d.irfft3`.

Scope of "exact": the representations span the zero-mean subspace; a
uniform mean flow is dropped on the way in.
"""

from __future__ import annotations

import numpy as np
import torch

from ns_tpu_torch.ops.cache import device_table
from ns_tpu_torch.solvers.spectral3d import (Spectral3DConfig,
                                             _dealias_mask_np,
                                             _wavenumbers_np, irfft3)
from ns_tpu_torch.solvers.spectral_periodic import _ik_mul

_AXES = (-3, -2, -1)


@device_table()
def _ops(nx: int, ny: int, nz: int, dtype: torch.dtype,
         device: torch.device) -> dict:
    """kx, ky, kz, 1/|k|^2 (0 at k = 0) of the full rfftn layout in `dtype`,
    and the 2/3-band mask."""
    cfg = Spectral3DConfig(nx=nx, ny=ny, nz=nz, transform="fft",
                           dealias=True)
    kx, ky, kz = _wavenumbers_np(cfg)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    t = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)  # noqa: E731
    return dict(kx=t(kx), ky=t(ky), kz=t(kz), inv_k2=t(inv_k2),
                mask=torch.as_tensor(_dealias_mask_np(cfg), device=device))


def _ops_of(x: torch.Tensor) -> dict:
    return _ops(*x.shape[-3:], x.dtype, x.device)


def _rfft3(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfftn(x, dim=_AXES)


def _curl_hat(ops, f_hat: torch.Tensor) -> torch.Tensor:
    """(i k x f)_hat for stacked (..., 3, nx, ny, nzh) spectra."""
    fx, fy, fz = f_hat.unbind(-4)
    kx, ky, kz = ops["kx"], ops["ky"], ops["kz"]
    return torch.stack([_ik_mul(ky, fz) - _ik_mul(kz, fy),
                        _ik_mul(kz, fx) - _ik_mul(kx, fz),
                        _ik_mul(kx, fy) - _ik_mul(ky, fx)], dim=-4)


def vorticity3d_from_velocity(uvw: torch.Tensor) -> torch.Tensor:
    """omega = curl(u), (..., 3, nx, ny, nz) -> (..., 3, nx, ny, nz), on the
    2/3 band (the solver's dealiased manifold)."""
    ops = _ops_of(uvw)
    return irfft3(torch.where(ops["mask"], _curl_hat(ops, _rfft3(uvw)), 0.0),
                  uvw.shape[-3:])


def velocity_from_vorticity3d_hat(ops, om_hat: torch.Tensor) -> torch.Tensor:
    """Biot-Savart on the 2/3 band: u_hat = i k x omega_hat / |k|^2, exactly
    solenoidal for any om_hat; the k = 0 mode maps to zero."""
    return torch.where(ops["mask"], _curl_hat(ops, om_hat) * ops["inv_k2"],
                       0.0)


def _pressure_from_u(ops, u: torch.Tensor, rho: float = 1.0) -> torch.Tensor:
    """The diagnostic spectral pressure of a physical velocity (..., 3, nx,
    ny, nz) -> (..., nx, ny, nz), the solver's formulas
    (`spectral3d.pressure_from_hat`), the six products in one transform."""
    ux, uy, uz = u.unbind(-4)
    T = _rfft3(torch.stack([ux * ux, uy * uy, uz * uz, ux * uy, ux * uz,
                            uy * uz], dim=-4)).unbind(-4)
    kx, ky, kz = ops["kx"], ops["ky"], ops["kz"]
    kk = (kx ** 2 * T[0] + ky ** 2 * T[1] + kz ** 2 * T[2]
          + 2.0 * (kx * ky * T[3] + kx * kz * T[4] + ky * kz * T[5]))
    return irfft3(-rho * kk * ops["inv_k2"], u.shape[-3:])


def _with_pressure(ops, u: torch.Tensor, rho: float) -> torch.Tensor:
    return torch.cat([u, _pressure_from_u(ops, u, rho).unsqueeze(-4)],
                     dim=-4)


def uvwp_from_omega(omega: torch.Tensor, rho: float = 1.0) -> torch.Tensor:
    """Exact zero-mean (u, v, w, p) from vorticity (..., 3, nx, ny, nz) ->
    (..., 4, nx, ny, nz): velocity by Biot-Savart, pressure by the solver's
    spectral Poisson solve."""
    ops = _ops_of(omega)
    u = irfft3(velocity_from_vorticity3d_hat(ops, _rfft3(omega)),
               omega.shape[-3:])
    return _with_pressure(ops, u, rho)


def vecpot_from_velocity(uvw: torch.Tensor) -> torch.Tensor:
    """The Coulomb-gauge vector potential with curl(A) = u: A_hat = i k x
    u_hat / |k|^2 on the 2/3 band, (..., 3, nx, ny, nz) -> same shape. The
    smooth representation: the curl recovery damps high-k prediction noise
    by 1/k where omega's amplifies it."""
    ops = _ops_of(uvw)
    a_hat = torch.where(ops["mask"],
                        _curl_hat(ops, _rfft3(uvw)) * ops["inv_k2"], 0.0)
    return irfft3(a_hat, uvw.shape[-3:])


def uvwp_from_vecpot(A: torch.Tensor, rho: float = 1.0) -> torch.Tensor:
    """Exact zero-mean (u, v, w, p) from a vector potential (..., 3, nx, ny,
    nz) -> (..., 4, nx, ny, nz): u = curl(A) on the 2/3 band, the same
    diagnostic pressure as `uvwp_from_omega`."""
    ops = _ops_of(A)
    u = irfft3(torch.where(ops["mask"], _curl_hat(ops, _rfft3(A)), 0.0),
               A.shape[-3:])
    return _with_pressure(ops, u, rho)


def repr3d_fns(model: str):
    """(to_representation(uvw), to_uvwp(field)) of a 3D divergence-free
    family: fno3d_w (vorticity) or fno3d_a (vector potential)."""
    return {"fno3d_w": (vorticity3d_from_velocity, uvwp_from_omega),
            "fno3d_a": (vecpot_from_velocity, uvwp_from_vecpot)}[model]


def dealias_field3d(x: torch.Tensor) -> torch.Tensor:
    """Project physical fields (..., nx, ny, nz) onto the solver's 2/3 band:
    the closed-loop stability filter of the vorticity and vector-potential
    rollouts."""
    return irfft3(torch.where(_ops_of(x)["mask"], _rfft3(x), 0.0),
                  x.shape[-3:])
