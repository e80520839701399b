"""Fourier Neural Operator surrogate: a learned next-step flow map.

Port of `ns_tpu/models/fno.py`. The FNO learns the one-step operator
(u, v, p)_t -> (u, v, p)_{t+1} with spectral convolutions (per-mode complex
channel mixing on a truncated mode block). Layout: lift (a 1x1
convolution on the fields and the two coordinate channels) -> L x
[spectral convolution + pointwise bypass, tanh-GELU] -> project, and the
model learns the residual (x + correction).

Two engines compute the same layer, so a checkpoint serves on either:
  - 'fft': `torch.fft.rfft2` (cuFFT on the card), the retained rows and
    columns gathered, mixed, scattered into a zero spectrum and inverted
    by `spectral_periodic.irfft2` (the mixed spectrum is not Hermitian:
    cuFFT's two-dimensional C2R is not used on it);
  - 'matmul': truncated DFT products that compute only the retained
    (2mx, my) block, forward x @ fc then fr @ (.) and inverse Re(gr @ Z @
    gc), the last as one real product on the interleaved parts of Z.
'auto' takes matmul at or below `_MATMUL_MAX_SIDE` (the TPU's choice; its
measurement on the card is `tools/torch_fno_engines.py`).

The spectral weights stay four real (C, C_out, mx, my) parameters (`lo_re`,
`lo_im`, `hi_re`, `hi_im`, the JAX names); they are combined into one
complex (2mx*my, C, C_out) table at use, once a `forward` or a `rollout`,
and the mixing is one batched product over the modes: (modes, B, C) @
(modes, C, C_out). Precision (`resolve_precision`): None, 'high' and
'highest' run fp32 with TF32 off (the complex products as cuBLAS complex
GEMMs), 'default' bf16 inputs with fp32 sums (the complex products as real
ones on the parts, `ops/gemm.py::cmatmul`). It governs the spectral layer;
the dense layers always run at None, as in the JAX package. The DFT
tables are built on the host in float64 and cached per shape, dtype and
device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ns_tpu_torch.models.layers import Dense
from ns_tpu_torch.ops.cache import device_table
from ns_tpu_torch.ops.gemm import cmatmul, matmul
from ns_tpu_torch.solvers.spectral_periodic import irfft2

# grids at or below this side take the matmul-DFT engine under
# transform='auto' (the TPU's crossover, kept until the card's reading of
# tools/torch_fno_engines.py moves it)
_MATMUL_MAX_SIDE = 512

_PRECISIONS = (None, "default", "high", "highest")


def resolve_precision(name):
    """The `ops/gemm.py` precision of the spectral layer: None (fp32 with
    TF32 off on the card; the TPU ran a bf16-class pass there), 'default',
    'high' or 'highest'. Raises ValueError for any other name."""
    if name not in _PRECISIONS:
        raise ValueError(f"precision must be None|default|high|highest, "
                         f"got {name!r}")
    return name


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


@device_table()
def _dft_mats(nx: int, ny: int, mx: int, my: int, dtype: torch.dtype,
              device: torch.device):
    """Truncated DFT tables of the retained block, built in float64 on the
    host, as (fc, fr, gr, gc) on `device`. Rows: the rfft2 rows the fft
    engine keeps (kx in [0, mx) and [nx-mx, nx)); columns ky in [0, my).
      fc (ny, 2my) real: the columns of exp(-2i pi y j / ny), real and
         imaginary parts interleaved, so x @ fc is x's column DFT as
         interleaved parts (a complex (..., nx, my) view);
      fr (2mx, nx) complex: the row DFT;
      gr (nx, 2mx) complex: the row inverse (1/nx);
      gc (2my, ny) real: rows Re and -Im interleaved of the column inverse
         with irfft's half-spectrum weights (2 for interior ky, 1 for ky = 0
         and the Nyquist column), so Re(Z @ gc_complex) is one real product
         on Z's interleaved parts.
    The half-spectrum weights are those of the solver's compact transforms
    and of vorticity._dealias_projectors."""
    k_rows = np.concatenate([np.arange(mx), np.arange(nx - mx, nx)])
    a, j, b = np.arange(nx), np.arange(my), np.arange(ny)
    fr = np.exp(-2j * np.pi * np.outer(k_rows, a) / nx)         # (2mx, nx)
    fc = np.exp(-2j * np.pi * np.outer(b, j) / ny)              # (ny, my)
    gr = np.exp(2j * np.pi * np.outer(a, k_rows) / nx) / nx     # (nx, 2mx)
    w = np.where((j == 0) | ((ny % 2 == 0) & (j == ny // 2)), 1.0, 2.0)
    gc = (w[:, None] * np.exp(2j * np.pi * np.outer(j, b) / ny)) / ny
    fc_i = np.stack([fc.real, fc.imag], axis=-1).reshape(ny, 2 * my)
    gc_i = np.stack([gc.real, -gc.imag], axis=1).reshape(2 * my, ny)
    cdt = _complex_dtype(dtype)
    t = lambda m, dt: torch.as_tensor(m).to(device=device, dtype=dt)
    return t(fc_i, dtype), t(fr, cdt), t(gr, cdt), t(gc_i, dtype)


def _cmm(a: torch.Tensor, b: torch.Tensor, prec) -> torch.Tensor:
    """A product of complex operands at `prec`: one complex GEMM (fp32, TF32
    off) unless 'default', which rounds the real and imaginary parts to
    bf16 (`cmatmul`)."""
    if prec == "default":
        return cmatmul(a, b, prec)
    return matmul(a, b, prec)


def _mix(block: torch.Tensor, W: torch.Tensor, prec) -> torch.Tensor:
    """block (..., C, R, my) x W (R*my, C, C_out) -> (..., C_out, R, my): the
    per-mode channel mixing as one batched product over the modes."""
    lead, (C, R, my) = block.shape[:-3], block.shape[-3:]
    b = block.reshape(-1, C, R * my).permute(2, 0, 1)        # (modes, B, C)
    out = _cmm(b, W, prec)                                   # (modes, B, C_out)
    return out.permute(1, 2, 0).reshape(*lead, W.shape[-1], R, my)


def _spectral_conv_fft(W, x: torch.Tensor, mx: int, my: int,
                       prec=None) -> torch.Tensor:
    """x (..., C, nx, ny) -> (..., C_out, nx, ny): per-retained-mode complex
    channel mixing, every other mode zeroed."""
    nx, ny = x.shape[-2], x.shape[-1]
    xh = torch.fft.rfft2(x)                                  # (..., C, nx, nyh)
    block = torch.cat([xh[..., :mx, :my], xh[..., nx - mx:, :my]], dim=-2)
    mixed = _mix(block, W, prec)                             # (..., C_out, 2mx, my)
    out = xh.new_zeros(mixed.shape[:-2] + xh.shape[-2:])
    out[..., :mx, :my] = mixed[..., :mx, :]
    out[..., nx - mx:, :my] = mixed[..., mx:, :]
    return irfft2(out, (nx, ny))


def _spectral_conv_matmul(W, x: torch.Tensor, mx: int, my: int,
                          prec=None) -> torch.Tensor:
    """The same layer as `_spectral_conv_fft` by truncated DFT products that
    compute only the retained block."""
    nx, ny = x.shape[-2], x.shape[-1]
    fc, fr, gr, gc = _dft_mats(nx, ny, mx, my, x.dtype, x.device)
    y = torch.view_as_complex(matmul(x, fc, prec).unflatten(-1, (my, 2)))
    xh = _cmm(fr, y, prec)                                   # (..., C, 2mx, my)
    z = _cmm(gr, _mix(xh, W, prec), prec)                    # (..., C_out, nx, my)
    return matmul(torch.view_as_real(z).flatten(-2), gc, prec)


def _spectral_conv(W, x: torch.Tensor, mx: int, my: int,
                   engine: str = "fft", prec=None) -> torch.Tensor:
    if engine == "matmul":
        return _spectral_conv_matmul(W, x, mx, my, prec)
    return _spectral_conv_fft(W, x, mx, my, prec)


class SpectralWeights(nn.Module):
    """Independent complex weights of the positive- and negative-kx mode
    blocks (the standard FNO weights1/weights2), as real/imaginary pairs
    (C, C_out, mx, my) drawn scale * N(0, 1)."""

    def __init__(self, c_in: int, c_out: int, mx: int, my: int,
                 scale: float, *, device=None, dtype=None, generator=None):
        super().__init__()
        shape = (c_in, c_out, mx, my)
        for name in ("lo_re", "lo_im", "hi_re", "hi_im"):
            p = torch.empty(shape, device=device, dtype=dtype)
            with torch.no_grad():
                p.normal_(generator=generator).mul_(scale)
            setattr(self, name, nn.Parameter(p))

    def mixing_table(self, dtype: torch.dtype) -> torch.Tensor:
        """(2mx*my, C, C_out) complex weights in `dtype`'s complex type, mode
        order as the retained block's rows (lo, then hi) and columns."""
        W = torch.cat([torch.complex(self.lo_re, self.lo_im),
                       torch.complex(self.hi_re, self.hi_im)], dim=2)
        C, C_out, R, my = W.shape
        W = W.to(_complex_dtype(dtype))
        return W.permute(2, 3, 0, 1).reshape(R * my, C, C_out)


def _resolve_transform(transform: str, *sides: int) -> str:
    if transform not in ("auto", "fft", "matmul"):
        raise ValueError(f"transform must be auto|fft|matmul, got "
                         f"{transform!r}")
    if transform == "auto":
        return "matmul" if max(sides) <= _MATMUL_MAX_SIDE else "fft"
    return transform


class NextStepOperator(nn.Module):
    """A residual next-step map x -> x + body(x): `prepare` builds what every
    step of a forward pass or a rollout shares, `_body` is the network."""

    def step(self, x: torch.Tensor, prepared) -> torch.Tensor:
        return x + self._body(x, prepared)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., channels, *grid) -> the next state."""
        return self.step(x, self.prepare(x.dtype, x.device))

    def rollout(self, x0: torch.Tensor, n_steps: int,
                post=None) -> torch.Tensor:
        """Autoregressive extrapolation: (..., C, *grid) -> stacked
        (n_steps, ..., C, *grid). `post`, if given, maps each prediction
        onto a constraint manifold before it is fed forward (dealias
        filtering, divergence projection)."""
        prepared = self.prepare(x0.dtype, x0.device)
        xs, x = [], x0
        for _ in range(n_steps):
            x = self.step(x, prepared)
            if post is not None:
                x = post(x)
            xs.append(x)
        return torch.stack(xs) if xs else x0.new_zeros((0,) + x0.shape)


class FNO2D(NextStepOperator):
    """Next-step operator on (..., channels, nx, ny) fields."""

    def __init__(self, nx: int, ny: int, width: int = 32, modes: int = 12,
                 depth: int = 4, channels: int = 3, transform: str = "auto",
                 precision: str | None = None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.transform = _resolve_transform(transform, nx, ny)
        self.nx, self.ny = nx, ny
        self.width, self.depth, self.channels = width, depth, channels
        self.mx = min(modes, nx // 2)
        self.my = min(modes, ny // 2 + 1)
        self.precision = resolve_precision(precision)
        kw = dict(device=device, dtype=dtype, generator=generator)
        scale = 1.0 / (width * width)
        self.lift = Dense(channels + 2, width, **kw)
        self.proj = Dense(width, self._head_channels(), **kw)
        self.spectral = nn.ModuleList(
            SpectralWeights(width, width, self.mx, self.my, scale, **kw)
            for _ in range(depth))
        self.bypass = nn.ModuleList(Dense(width, width, **kw)
                                    for _ in range(depth))

    def _head_channels(self) -> int:
        return self.channels

    def _coords(self, dtype, device) -> torch.Tensor:
        gx = torch.linspace(0.0, 1.0, self.nx, dtype=dtype, device=device)
        gy = torch.linspace(0.0, 1.0, self.ny, dtype=dtype, device=device)
        return torch.stack([gx[:, None].expand(self.nx, self.ny),
                            gy[None, :].expand(self.nx, self.ny)])

    def prepare(self, dtype, device):
        """What every step of a forward pass or a rollout shares: the
        coordinate channels and each layer's complex mixing table."""
        return (self._coords(dtype, device),
                [s.mixing_table(dtype) for s in self.spectral])

    def _body(self, x: torch.Tensor, prepared) -> torch.Tensor:
        """The network: (..., channels, nx, ny) -> (..., head, nx, ny)."""
        coords, tables = prepared
        h = torch.cat([x, coords.expand(*x.shape[:-3], 2, self.nx, self.ny)],
                      dim=-3)
        h = self.lift.channels(h)                            # (..., W, nx, ny)
        for W, byp in zip(tables, self.bypass):
            s = _spectral_conv(W, h, self.mx, self.my, self.transform,
                               self.precision)
            h = F.gelu(s + byp.channels(h), approximate="tanh")
        return self.proj.channels(h)
