"""Vorticity-space helpers for the periodic surrogates.

Port of `ns_tpu/models/vorticity.py`. For periodic incompressible 2D flow
the scalar vorticity w determines the zero-mean (u, v, p) state exactly
(streamfunction recovery and the pressure Poisson solve, the identities of
the spectral solver), so a surrogate that predicts w models one channel
instead of three and is divergence-free by construction.

These are thin adapters over the port's spectral solver
(`solvers/spectral_periodic.py`: `make_ops`, `_ik_mul`,
`velocity_from_vorticity_hat`) on its conventions (2*pi-periodic domain,
integer wavenumbers, rfft2 layout). Every function takes leading batch
axes (the JAX package's `uvp_from_w` is per sample and `vmap`ped) and
computes in the input's dtype on its device. The spectra that `i k` makes
non-Hermitian (the unpaired Nyquist modes) are inverted by
`spectral_periodic.irfft2`. The constants are cached per shape, dtype and
device.

Scope of "exact": the representation spans the zero-mean subspace; a
uniform background flow is dropped on the way in.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ns_tpu_torch.ops.cache import device_table
from ns_tpu_torch.ops.gemm import matmul
from ns_tpu_torch.solvers.spectral_periodic import (
    SpectralPeriodicConfig, _ik_mul, irfft2, make_ops,
    velocity_from_vorticity_hat)


@device_table()
def _ops(nx: int, ny: int, dtype: torch.dtype, device: torch.device):
    name = "float64" if dtype == torch.float64 else "float32"
    return make_ops(SpectralPeriodicConfig(nx=nx, ny=ny, dtype=name), device)


def vorticity_from_uv(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = dv/dx - du/dy on the solver's periodic grid, (..., nx, ny) ->
    (..., nx, ny)."""
    nx, ny = u.shape[-2], u.shape[-1]
    ops = _ops(nx, ny, u.dtype, u.device)
    w_hat = (_ik_mul(ops["kx"], torch.fft.rfft2(v))
             - _ik_mul(ops["ky"], torch.fft.rfft2(u)))
    return irfft2(w_hat, (nx, ny))


def uvp_from_w(w: torch.Tensor, rho: float = 1.0):
    """Exact zero-mean (u, v, p) from vorticity (..., nx, ny): u, v by the
    streamfunction, p by the spectral pressure Poisson solve, the formulas
    of the data-generating solver; the six inverse transforms are one
    batched call."""
    nx, ny = w.shape[-2], w.shape[-1]
    ops = _ops(nx, ny, w.dtype, w.device)
    u_hat, v_hat = velocity_from_vorticity_hat(torch.fft.rfft2(w), ops)
    kx, ky = ops["kx"], ops["ky"]
    u, v, ux, uy, vx, vy = irfft2(torch.stack(
        [u_hat, v_hat, _ik_mul(kx, u_hat), _ik_mul(ky, u_hat),
         _ik_mul(kx, v_hat), _ik_mul(ky, v_hat)], dim=-3), (nx, ny)).unbind(-3)
    rhs = -rho * (ux * ux + 2.0 * uy * vx + vy * vy)
    p = irfft2(-torch.fft.rfft2(rhs) * ops["inv_k2"], (nx, ny))
    return u, v, p


def dealias_field(w: torch.Tensor, engine: str = "auto") -> torch.Tensor:
    """Project a physical field (..., nx, ny) onto the solver's 2/3-rule
    band, the rollout stability filter. 'fft' masks the rfft2 spectrum;
    'matmul' applies the same projection as two real products with cosine
    kernels (the band is +/- symmetric); 'auto' takes matmul at or below
    fno._MATMUL_MAX_SIDE. The products run at precision None."""
    if engine not in ("auto", "fft", "matmul"):
        raise ValueError(f"engine must be auto|fft|matmul, got {engine!r}")
    nx, ny = w.shape[-2], w.shape[-1]
    if engine == "auto":
        from ns_tpu_torch.models.fno import _MATMUL_MAX_SIDE
        engine = "matmul" if max(nx, ny) <= _MATMUL_MAX_SIDE else "fft"
    if engine == "matmul":
        pr, pc = _projectors(nx, ny, w.dtype, w.device)
        return matmul(pr, matmul(w, pc, None), None)
    mask = _band_mask(nx, ny, w.device)
    return irfft2(torch.where(mask, torch.fft.rfft2(w), 0.0), (nx, ny))


@device_table()
def _band_mask(nx: int, ny: int, device: torch.device) -> torch.Tensor:
    kx = np.fft.fftfreq(nx, d=1.0 / nx)
    ky = np.fft.rfftfreq(ny, d=1.0 / ny)
    mask = (np.abs(kx)[:, None] < nx / 3.0) & (np.abs(ky)[None, :] < ny / 3.0)
    return torch.as_tensor(mask, device=device)


@lru_cache(maxsize=16)
def _dealias_projectors(nx: int, ny: int):
    """Real (nx, nx) row and (ny, ny) column projection kernels equal to
    the masked-rfft2 round trip, built in float64 and rounded to float32
    (as the JAX package keeps them, in float64 runs too). Row kernel:
    (1/nx) sum over the +/- symmetric retained kx of exp(2i pi kx (a -
    a')/nx), real by symmetry. Column kernel: irfft's half-spectrum weights
    (1 for ky = 0 and Nyquist, 2 otherwise) over the retained non-negative
    ky, real part; returned transposed, so the filter is pr @ w @ pc."""
    kx = np.fft.fftfreq(nx, d=1.0 / nx)
    a = np.arange(nx)
    pr = np.zeros((nx, nx))
    for k in kx[np.abs(kx) < nx / 3.0]:
        pr += np.real(np.exp(2j * np.pi * k * (a[:, None] - a[None, :])
                             / nx)) / nx
    ky = np.fft.rfftfreq(ny, d=1.0 / ny)
    keep_y = np.where(ky < ny / 3.0)[0]
    b = np.arange(ny)
    wts = np.where((keep_y == 0) | ((ny % 2 == 0) & (keep_y == ny // 2)),
                   1.0, 2.0)
    pc = np.zeros((ny, ny))
    for j, wj in zip(ky[keep_y], wts):
        pc += wj * np.cos(2 * np.pi * j * (b[:, None] - b[None, :])
                          / ny) / ny
    return pr.astype(np.float32), pc.T.astype(np.float32)


@device_table()
def _projectors(nx: int, ny: int, dtype: torch.dtype, device: torch.device):
    t = lambda m: torch.as_tensor(m).to(device=device, dtype=dtype)
    return tuple(t(m) for m in _dealias_projectors(nx, ny))
