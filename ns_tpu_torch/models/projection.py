"""Training-free divergence-free projection of predicted velocity fields.

Port of `ns_tpu/models/projection.py`. A Helmholtz projection

    u <- u - grad(phi),   laplace(phi) = div(u)

restores div(u) = 0 without touching the model:
  - periodic: diagonal in Fourier space (one rfft2 pair; in 3D the Leray
    projection of (u, v, w), one rfftn pair, and the 3D rollout filter,
    which also dealiases every channel);
  - bounded (the reference's cavity data): phi solves a homogeneous-
    Dirichlet Poisson problem by the port's geometric multigrid (2^k + 1
    grids), with backward divergence and forward gradient, whose
    composition is the compact 5-point Laplacian the multigrid solves.
Plain torch functions, usable as a post-processor of any model's outputs
or inside a training loss.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ns_tpu_torch.ops.cache import device_table
from ns_tpu_torch.ops.multigrid import poisson_multigrid
from ns_tpu_torch.solvers.spectral3d import irfft3
from ns_tpu_torch.solvers.spectral_periodic import _ik_mul, irfft2


@device_table()
def _periodic_ops(nx: int, ny: int, dtype: torch.dtype, device: torch.device):
    """kx (nx, 1), ky (1, nyh) with the unpaired Nyquist modes zeroed (i*k
    on the lone -N/2 mode is not the spectrum of any real field), and 1/k^2
    with the mean mode 0."""
    kx = np.fft.fftfreq(nx, d=1.0 / nx)[:, None]
    ky = np.fft.rfftfreq(ny, d=1.0 / ny)[None, :]
    if nx % 2 == 0:
        kx[nx // 2, 0] = 0.0
    if ny % 2 == 0:
        ky[0, -1] = 0.0
    k2 = kx * kx + ky * ky
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    t = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    return t(kx), t(ky), t(inv_k2)


def project_periodic(u: torch.Tensor, v: torch.Tensor):
    """Exact spectral Helmholtz projection on [0, 2*pi)^2 grids of any shape
    (..., nx, ny)."""
    nx, ny = u.shape[-2], u.shape[-1]
    kx, ky, inv_k2 = _periodic_ops(nx, ny, u.dtype, u.device)
    uh, vh = torch.fft.rfft2(u), torch.fft.rfft2(v)
    div_h = _ik_mul(kx, uh) + _ik_mul(ky, vh)
    phi_h = -div_h * inv_k2          # laplace(phi) = div -> -k^2 phi = div
    u_p = irfft2(uh - _ik_mul(kx, phi_h), (nx, ny))
    v_p = irfft2(vh - _ik_mul(ky, phi_h), (nx, ny))
    return u_p, v_p


def divergence_central(u: torch.Tensor, v: torch.Tensor, dx: float,
                       dy: float) -> torch.Tensor:
    """Interior central-difference divergence (the reference direct_fd axis
    convention: x along axis 1), zero on the boundary ring."""
    interior = ((u[..., 1:-1, 2:] - u[..., 1:-1, :-2]) / (2 * dx)
                + (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) / (2 * dy))
    return F.pad(interior, (1, 1, 1, 1))


def divergence_backward(u: torch.Tensor, v: torch.Tensor, dx: float,
                        dy: float) -> torch.Tensor:
    """Backward-difference divergence (x along axis 1), zero on the first
    row and column: the adjoint-consistent partner of the forward gradient,
    D_bwd(G_fwd phi) = the compact 5-point Laplacian."""
    interior = ((u[..., 1:, 1:] - u[..., 1:, :-1]) / dx
                + (v[..., 1:, 1:] - v[..., :-1, 1:]) / dy)
    return F.pad(interior, (1, 0, 1, 0))


def project_bounded(u: torch.Tensor, v: torch.Tensor, dx: float, dy: float,
                    n_cycles: int = 10):
    """Discrete Helmholtz projection on a bounded 2^k + 1 grid (nx, ny):
    backward divergence, a multigrid solve with phi = 0 on the boundary,
    forward gradient. D_bwd(u', v') = 0 on the interior up to the solver's
    tolerance; boundary values change only by the forward-gradient update
    of columns and rows < n - 1."""
    d = divergence_backward(u, v, dx, dy)
    d = F.pad(d[1:-1, 1:-1], (1, 1, 1, 1))   # multigrid solves the interior
    # spacings SWAPPED on purpose: div/grad here put x along axis 1 (the
    # reference direct_fd convention) while poisson_multigrid applies its
    # first spacing along axis 0 (the chorin_fd convention); unswapped,
    # anisotropic grids get worse after "projection"
    phi = poisson_multigrid(torch.zeros_like(u), d, dy, dx,
                            n_cycles=n_cycles)
    gx = F.pad((phi[:, 1:] - phi[:, :-1]) / dx, (0, 1, 0, 0))
    gy = F.pad((phi[1:, :] - phi[:-1, :]) / dy, (0, 0, 0, 1))
    return u - gx, v - gy


@device_table()
def _leray3d_ops(nx: int, ny: int, nz: int, dtype: torch.dtype,
                 device: torch.device):
    """((kx (nx, 1, 1), ky (1, ny, 1), kz (1, 1, nzh)) with the unpaired
    Nyquist modes zeroed, 1/k^2 with the mean mode 0), and the 2/3-band
    mask of the rfftn layout."""
    kx = np.fft.fftfreq(nx, d=1.0 / nx)[:, None, None]
    ky = np.fft.fftfreq(ny, d=1.0 / ny)[None, :, None]
    kz = np.fft.rfftfreq(nz, d=1.0 / nz)[None, None, :]
    mask = ((np.abs(kx) < nx / 3.0) & (np.abs(ky) < ny / 3.0)
            & (kz < nz / 3.0))
    if nx % 2 == 0:
        kx[nx // 2] = 0.0
    if ny % 2 == 0:
        ky[0, ny // 2] = 0.0
    if nz % 2 == 0:
        kz[0, 0, -1] = 0.0
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    t = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)  # noqa: E731
    return ((t(kx), t(ky), t(kz), t(inv_k2)),
            torch.as_tensor(mask, device=device))


def _leray3d_hat(k, uh, vh, wh):
    """The projected spectra: v_hat - k (k . v_hat) / k^2."""
    kx, ky, kz, inv_k2 = k
    corr = (kx * uh + ky * vh + kz * wh) * inv_k2
    return uh - kx * corr, vh - ky * corr, wh - kz * corr


def project_leray3d(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor):
    """Exact spectral Leray projection on [0, 2*pi)^3 grids of any shape
    (..., nx, ny, nz), the 3D counterpart of `project_periodic`."""
    s = u.shape[-3:]
    k, _ = _leray3d_ops(*s, u.dtype, u.device)
    uvw = torch.fft.rfftn(torch.stack([u, v, w], dim=-4), dim=(-3, -2, -1))
    out = irfft3(torch.stack(_leray3d_hat(k, *uvw.unbind(-4)), dim=-4), s)
    return out.unbind(-4)


def rollout_filter3d(x: torch.Tensor, project: bool = True,
                     dealias: bool = True) -> torch.Tensor:
    """The constraint filter of 3D surrogate rollouts on channel-stacked
    (..., 4, nx, ny, nz) (u, v, w, p) states: the 2/3-band dealias of every
    channel and/or the exact Nyquist-safe Leray projection of the velocity
    channels, in one spectral round trip."""
    if not (project or dealias):
        return x
    s = x.shape[-3:]
    k, mask = _leray3d_ops(*s, x.dtype, x.device)
    xh = torch.fft.rfftn(x, dim=(-3, -2, -1))
    if dealias:
        xh = torch.where(mask, xh, 0.0)
    if project:
        uh, vh, wh, ph = xh.unbind(-4)
        xh = torch.stack([*_leray3d_hat(k, uh, vh, wh), ph], dim=-4)
    return irfft3(xh, s)
