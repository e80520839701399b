"""Streamfunction-head FNO: a divergence-free surrogate in the (u, v, p)
contract.

Port of `ns_tpu/models/streamfunction.py`. FNOPsi keeps FNO2D's (u, v, p)
inputs, outputs and body and changes only the head: the network predicts a
streamfunction increment d_psi and a pressure increment d_p, and the
velocity update is the exact spectral curl

    u <- u + d(d_psi)/dy,    v <- v - d(d_psi)/dx,    p <- p + d_p

so every velocity increment is divergence-free. The derivatives run as
real circulant products (host-built float64 kernels, one per axis): d/dx
acts on axis -2 and d/dy on axis -1, so div(curl) cancels to rounding. The
increment is first restricted to the 2/3 band, where every spectral
convention agrees. The kernel products run at the model's precision, or
'highest' when it is None (as the JAX package does).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ns_tpu_torch.models.fno import FNO2D
from ns_tpu_torch.ops.cache import device_table
from ns_tpu_torch.ops.gemm import matmul


@lru_cache(maxsize=16)
def _deriv_kernel(n: int) -> np.ndarray:
    """Real (n, n) circulant spectral-derivative matrix on the 2*pi-periodic
    n-point grid: D = Re[F^H diag(i k) F], k = fftfreq * n, with the
    unpaired Nyquist mode zeroed (as in projection.project_periodic).
    Host float64."""
    k = np.fft.fftfreq(n, d=1.0 / n)
    if n % 2 == 0:
        k = k.copy()
        k[n // 2] = 0.0
    a = np.arange(n)
    E = np.exp(2j * np.pi * np.outer(a, k) / n)
    return np.real((E * (1j * k)) @ E.conj().T / n)


@lru_cache(maxsize=16)
def _band_kernel(n: int) -> np.ndarray:
    """Real (n, n) circulant 2/3-band projector (|k| < n/3). Host float64."""
    k = np.fft.fftfreq(n, d=1.0 / n)
    keep = (np.abs(k) < n / 3.0).astype(np.float64)
    a = np.arange(n)
    E = np.exp(2j * np.pi * np.outer(a, k) / n)
    return np.real((E * keep) @ E.conj().T / n)


@device_table()
def _kernels(nx: int, ny: int, dtype: torch.dtype, device: torch.device):
    """(Dx, Dy^T, Bx, By^T) on `device`."""
    t = lambda m: torch.as_tensor(m).to(device=device, dtype=dtype)
    return (t(_deriv_kernel(nx)), t(_deriv_kernel(ny).T),
            t(_band_kernel(nx)), t(_band_kernel(ny).T))


class FNOPsi(FNO2D):
    """Next-step operator on (..., 3, nx, ny) (u, v, p) fields with a
    streamfunction velocity head; the body is FNO2D's."""

    def __init__(self, nx: int, ny: int, width: int = 32, modes: int = 12,
                 depth: int = 4, channels: int = 3, transform: str = "auto",
                 precision: str | None = None, **kw):
        if channels != 3:
            raise ValueError(
                f"fno_psi is the (u,v,p)-contract family (channels=3); "
                f"got channels={channels}")
        super().__init__(nx, ny, width, modes, depth, channels, transform,
                         precision, **kw)

    def _head_channels(self) -> int:
        return 2  # (d_psi, d_p): u and v come from d_psi

    def step(self, x: torch.Tensor, prepared) -> torch.Tensor:
        out = self._body(x, prepared)                        # (..., 2, nx, ny)
        d_psi, d_p = out[..., 0, :, :], out[..., 1, :, :]
        Dx, DyT, Bx, ByT = _kernels(self.nx, self.ny, x.dtype, x.device)
        prec = self.precision or "highest"
        # band-limit the increment, then differentiate
        psi_b = matmul(Bx, matmul(d_psi, ByT, prec), prec)
        du = matmul(psi_b, DyT, prec)                        # d(psi_b)/dy
        dv = -matmul(Dx, psi_b, prec)                        # -d(psi_b)/dx
        return torch.stack([x[..., 0, :, :] + du, x[..., 1, :, :] + dv,
                            x[..., 2, :, :] + d_p], dim=-3)
