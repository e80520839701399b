"""3D Fourier Neural Operator: a learned next-step map of 3D periodic flow.

Port of `ns_tpu/models/fno3d.py`, the 3D counterpart of `models/fno.py`.
The operator maps (..., C, nx, ny, nz) states (C = 4: u, v, w, p for
fno3d; 3 for the vorticity and vector-potential families) to the next
one: lift (the fields and three coordinate channels) -> L x [spectral
convolution + pointwise bypass, tanh-GELU] -> project, residual x +
correction.

Retained block: kx in [0, mx) and [nx-mx, nx), ky in [0, my) and [ny-my,
ny), kz in [0, mz) (the rfft half axis), one weight per mode of the
(2mx, 2my, mz) block. Two engines compute the same layer, so a checkpoint
serves on either:
  - 'fft': `torch.fft.rfftn` (cuFFT on the card), the four corner blocks
    gathered, mixed, scattered into a zero spectrum and inverted by
    `spectral3d.irfft3` (the mixed spectrum is not Hermitian on kz = 0);
  - 'matmul': truncated DFT products that compute only the retained block:
    z as one real product (interleaved parts), then the complex y and x
    stages, and the inverse in reverse, each through `ops/gemm.py` at the
    model's precision, the last as one real product on Z's interleaved
    parts. The DFT tables are built on the host in float64 and cached per
    shape, dtype and device.
'auto' takes matmul at or below `fno._MATMUL_MAX_SIDE` (the TPU's choice).

The spectral weights are stored as the JAX package stores them: `re` and
`im` of shape (C_out, C_in, 2mx*2my*mz), the mode axes flattened (the
transpose of the 2D family's channel order). The mixing is one batched
complex product over the modes, (modes, B, C_in) @ (modes, C_in, C_out),
from the table W.permute(2, 1, 0) built once a forward or a rollout. It
runs fp32 with TF32 off at every precision, 'default' included: the JAX
package's `_mix3d` is a multiply-reduce that takes no precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ns_tpu_torch.models.fno import (NextStepOperator, _cmm, _complex_dtype,
                                     _resolve_transform, resolve_precision)
from ns_tpu_torch.models.layers import Dense
from ns_tpu_torch.ops.cache import device_table
from ns_tpu_torch.ops.gemm import matmul
from ns_tpu_torch.solvers.spectral3d import irfft3


def _rows(n: int, m: int) -> np.ndarray:
    return np.concatenate([np.arange(m), np.arange(n - m, n)])


@device_table()
def _dft_mats3d(nx: int, ny: int, nz: int, mx: int, my: int, mz: int,
                dtype: torch.dtype, device: torch.device):
    """Truncated per-axis DFT tables of the retained (2mx, 2my, mz) block,
    built in float64 on the host, as (fz, fy, fx, gx, gy, gz) on `device`:
      fz (nz, 2mz) real: the columns of exp(-2i pi z k / nz), real and
         imaginary parts interleaved, so x @ fz is the z-DFT as interleaved
         parts (a complex (..., ny, mz) view);
      fy (2my, ny), fx (2mx, nx) complex: the y and x DFTs of the kept rows;
      gx (nx, 2mx), gy (ny, 2my) complex: their inverses (1/n);
      gz (2mz, nz) real: rows Re and -Im interleaved of the z inverse with
         irfft's half-spectrum weights (1 at kz = 0 and Nyquist, 2
         otherwise), so Re(Z @ gz_complex) is one real product on Z's
         interleaved parts."""
    rx, ry = _rows(nx, mx), _rows(ny, my)
    a, b, c, j = np.arange(nx), np.arange(ny), np.arange(nz), np.arange(mz)
    fx = np.exp(-2j * np.pi * np.outer(rx, a) / nx)
    fy = np.exp(-2j * np.pi * np.outer(ry, b) / ny)
    fz = np.exp(-2j * np.pi * np.outer(c, j) / nz)
    gx = np.exp(2j * np.pi * np.outer(a, rx) / nx) / nx
    gy = np.exp(2j * np.pi * np.outer(b, ry) / ny) / ny
    wz = np.where((j == 0) | ((nz % 2 == 0) & (j == nz // 2)), 1.0, 2.0)
    gz = (wz[:, None] * np.exp(2j * np.pi * np.outer(j, c) / nz)) / nz
    fz_i = np.stack([fz.real, fz.imag], axis=-1).reshape(nz, 2 * mz)
    gz_i = np.stack([gz.real, -gz.imag], axis=1).reshape(2 * mz, nz)
    cdt = _complex_dtype(dtype)
    t = lambda m, dt: torch.as_tensor(m).to(device=device, dtype=dt)  # noqa: E731
    return (t(fz_i, dtype), t(fy, cdt), t(fx, cdt), t(gx, cdt), t(gy, cdt),
            t(gz_i, dtype))


def _mix3d(block: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """block (..., C, X, Y, Z) x W (X*Y*Z, C, C_out) -> (..., C_out, X, Y, Z):
    the per-mode channel mixing as one batched complex product over the
    modes, fp32 with TF32 off (float64 in float64) at every precision."""
    lead, (C, X, Y, Z) = block.shape[:-4], block.shape[-4:]
    b = block.reshape(-1, C, X * Y * Z).permute(2, 0, 1)    # (modes, B, C)
    out = matmul(b, W, None)                                 # (modes, B, C_out)
    return out.permute(1, 2, 0).reshape(*lead, W.shape[-1], X, Y, Z)


def _spectral_conv3d_fft(W, x: torch.Tensor, mx: int, my: int, mz: int,
                         prec=None) -> torch.Tensor:
    """x (..., C, nx, ny, nz) -> (..., C_out, nx, ny, nz): per-retained-mode
    complex channel mixing, every other mode zeroed. `prec` does not reach
    the mixing (module docstring)."""
    del prec
    nx, ny, nz = x.shape[-3:]
    xh = torch.fft.rfftn(x, dim=(-3, -2, -1))                # (..., C, nx, ny, nzh)
    lo, hi = xh[..., :mx, :, :mz], xh[..., nx - mx:, :, :mz]
    block = torch.cat([torch.cat([q[..., :my, :], q[..., ny - my:, :]],
                                 dim=-2) for q in (lo, hi)], dim=-3)
    mixed = _mix3d(block, W)                                 # (..., C_out, 2mx, 2my, mz)
    out = xh.new_zeros(mixed.shape[:-3] + xh.shape[-3:])
    for xs, ms in ((slice(0, mx), slice(0, mx)),
                   (slice(nx - mx, nx), slice(mx, 2 * mx))):
        out[..., xs, :my, :mz] = mixed[..., ms, :my, :]
        out[..., xs, ny - my:, :mz] = mixed[..., ms, my:, :]
    return irfft3(out, (nx, ny, nz))


def _x_stage(M: torch.Tensor, t: torch.Tensor, prec) -> torch.Tensor:
    """Contract axis -3 of t (..., n, b, k) with M (m, n): (..., m, b, k)."""
    *lead, n, b, k = t.shape
    return _cmm(M, t.reshape(*lead, n, b * k), prec).reshape(
        *lead, M.shape[0], b, k)


def _spectral_conv3d_matmul(W, x: torch.Tensor, mx: int, my: int, mz: int,
                            prec=None) -> torch.Tensor:
    """The same layer as `_spectral_conv3d_fft` by truncated DFT products
    that compute only the retained block (z first, the axis that shrinks
    most, then y, then x; the inverse in reverse)."""
    nx, ny, nz = x.shape[-3:]
    fz, fy, fx, gx, gy, gz = _dft_mats3d(nx, ny, nz, mx, my, mz, x.dtype,
                                         x.device)
    t = torch.view_as_complex(matmul(x, fz, prec).unflatten(-1, (mz, 2)))
    t = _cmm(fy, t, prec)                                    # (..., C, nx, 2my, mz)
    xh = _x_stage(fx, t, prec)                               # (..., C, 2mx, 2my, mz)
    z = _x_stage(gx, _mix3d(xh, W), prec)                    # (..., C_out, nx, 2my, mz)
    z = _cmm(gy, z, prec)                                    # (..., C_out, nx, ny, mz)
    return matmul(torch.view_as_real(z).flatten(-2), gz, prec)


def _spectral_conv3d(W, x, mx, my, mz, engine="fft", prec=None):
    if engine == "matmul":
        return _spectral_conv3d_matmul(W, x, mx, my, mz, prec)
    return _spectral_conv3d_fft(W, x, mx, my, mz, prec)


class SpectralWeights3D(nn.Module):
    """One weight per retained mode, as real/imaginary pairs (C_out, C_in,
    2mx*2my*mz) drawn scale * N(0, 1)."""

    def __init__(self, c_in: int, c_out: int, modes: int, scale: float, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        for name in ("re", "im"):
            p = torch.empty((c_out, c_in, modes), device=device, dtype=dtype)
            with torch.no_grad():
                p.normal_(generator=generator).mul_(scale)
            setattr(self, name, nn.Parameter(p))

    def mixing_table(self, dtype: torch.dtype) -> torch.Tensor:
        """(modes, C_in, C_out) complex weights in `dtype`'s complex type:
        W.permute(2, 1, 0) of the stored (C_out, C_in, modes)."""
        W = torch.complex(self.re, self.im).to(_complex_dtype(dtype))
        return W.permute(2, 1, 0)


class FNO3D(NextStepOperator):
    """Next-step operator on (..., C, nx, ny, nz) fields (C = 4: u, v, w,
    p)."""

    def __init__(self, nx: int, ny: int, nz: int, width: int = 24,
                 modes: int = 8, depth: int = 4, channels: int = 4,
                 transform: str = "auto", precision: str | None = None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.transform = _resolve_transform(transform, nx, ny, nz)
        self.nx, self.ny, self.nz = nx, ny, nz
        self.width, self.depth, self.channels = width, depth, channels
        self.mx = min(modes, nx // 2)
        self.my = min(modes, ny // 2)
        self.mz = min(modes, nz // 2 + 1)
        self.precision = resolve_precision(precision)
        kw = dict(device=device, dtype=dtype, generator=generator)
        n_modes = 2 * self.mx * 2 * self.my * self.mz
        self.lift = Dense(channels + 3, width, **kw)
        self.proj = Dense(width, channels, **kw)
        self.spectral = nn.ModuleList(
            SpectralWeights3D(width, width, n_modes, 1.0 / (width * width),
                              **kw) for _ in range(depth))
        self.bypass = nn.ModuleList(Dense(width, width, **kw)
                                    for _ in range(depth))

    def _coords(self, dtype, device) -> torch.Tensor:
        shape = (self.nx, self.ny, self.nz)
        g = [torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
             for n in shape]
        return torch.stack([g[0][:, None, None].expand(shape),
                            g[1][None, :, None].expand(shape),
                            g[2][None, None, :].expand(shape)])

    def prepare(self, dtype, device):
        """The coordinate channels and each layer's complex mixing table."""
        return (self._coords(dtype, device),
                [s.mixing_table(dtype) for s in self.spectral])

    def _body(self, x: torch.Tensor, prepared) -> torch.Tensor:
        """The network: (..., C, nx, ny, nz) -> (..., C, nx, ny, nz)."""
        coords, tables = prepared
        h = torch.cat([x, coords.expand(*x.shape[:-4], 3, *coords.shape[1:])],
                      dim=-4)
        h = self.lift.channels(h, 3)                         # (..., W, nx, ny, nz)
        for W, byp in zip(tables, self.bypass):
            s = _spectral_conv3d(W, h, self.mx, self.my, self.mz,
                                 self.transform, self.precision)
            h = F.gelu(s + byp.channels(h, 3), approximate="tanh")
        return self.proj.channels(h, 3)
