"""2D periodic Fourier pseudospectral Navier-Stokes (vorticity form).

Port of `ns_tpu/solvers/spectral_periodic.py`. Incompressible NSE on
[0, 2*pi)^2 in vorticity-streamfunction form:

    d(omega)/dt + u . grad(omega) = nu * Lap(omega)
    Lap(psi) = -omega,  u = d(psi)/dy,  v = -d(psi)/dx

The streamfunction makes the velocity divergence-free exactly; the
"pressure solve" is the diagonal inverse Laplacian 1/k^2. Time integration
is integrating factor exp(-nu k^2 dt) for the viscous term plus
Adams-Bashforth-2 for advection; the nonlinear term is pseudospectral with
2/3-rule dealiasing. The carry is (w_hat, N_prev).

Engines (`SpectralPeriodicConfig.transform`, `compact_spectrum`,
`real_gemm`):
  - 'fft': `torch.fft.rfft2`/`irfft2` (cuFFT on the card), rfft2 layout.
  - 'matmul': the DFT as GEMMs in the same rfft2 layout (padded), or, with
    `compact_spectrum`, on the dealias-truncated compact layout (Rx, kyc)
    that the carry keeps through the rollout.
  - `real_gemm` (compact only): the carry as stacked (2, Rx, kyc) real and
    imaginary parts and every transform stage as one real block GEMM.
Every GEMM runs through `ops/gemm.py` at `matmul_precision` ('default':
bf16 inputs and an fp32 result; 'high' and 'highest': fp32 with TF32 off).
The complex engines keep their tables as real matrices whose columns or
rows interleave real and imaginary parts, so a complex stage is one real
GEMM on `torch.view_as_real` of the operand, and the inverse's second
stage computes only the real part it needs. At 'default' the float32
tables are rounded to bf16 once, when they are built.

The host-side layout helpers, DFT constants and initial conditions are
numpy copies of the JAX module's (that module imports jax), so the same
seed gives bitwise-equal inputs in both packages. Leading batch axes
broadcast through every engine. Rollouts are Python loops of `step` on the
carry's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.ops.cache import device_table
from ns_tpu_torch.ops.gemm import matmul


@dataclasses.dataclass(frozen=True)
class SpectralPeriodicConfig:
    nt: int = 200
    nx: int = 256
    ny: int = 256
    dt: float = 0.001
    nu: float = 1e-3
    rho: float = 1.0  # kept for API symmetry with the other families
    dealias: bool = True
    dtype: str = "float32"  # 'float32' | 'float64'
    # 'fft' (default) | 'matmul' | 'auto': the engine by the card's
    # measured rule, resolved at construction (__post_init__), so
    # downstream code only sees a concrete engine
    transform: str = "fft"
    # matmul-DFT precision: 'default' (bf16 inputs, fp32 result), 'high'
    # and 'highest' (fp32, TF32 off). Divergence-free-ness is exact in all
    # modes (streamfunction form).
    matmul_precision: str = "high"
    # carry the dealias-truncated spectrum (Rx, kyc) through the rollout
    # (matmul + dealias only); expand_compact() restores the rfft2 layout
    compact_spectrum: bool = False
    # real block-GEMM engine (compact only): the carry as (2, Rx, kyc)
    real_gemm: bool = False
    # constant-in-time vorticity forcing:
    #   'none'        unforced (default)
    #   'kolmogorov'  f_w = -amp*k*cos(k*y) (curl of (amp*sin(k*y), 0));
    #                 laminar fixed point w_s = f_w/(nu*k^2)
    #   'fno'         f_w = amp*(sin(k*(x+y)) + cos(k*(x+y))) (the FNO
    #                 Navier-Stokes benchmark's forcing, Li et al. 2021)
    forcing: str = "none"
    forcing_k: int = 4
    forcing_amp: float = 0.1

    def __post_init__(self):
        if self.forcing not in ("none", "kolmogorov", "fno"):
            raise ValueError(f"forcing must be 'none'|'kolmogorov'|'fno', "
                             f"got {self.forcing!r}")
        if self.forcing != "none" and self.forcing_k < 1:
            raise ValueError(f"forcing_k must be >= 1, got {self.forcing_k}")
        if self.transform == "auto":
            # The JAX package takes matmul + compact below 8192^2 when
            # dealiased (the TPU's MXU beat its FFT at every size measured
            # there). On an NVIDIA H100 80GB HBM3 at 700 W the fft step
            # loop ran ahead of the compact matmul one from 1024^2 at
            # 'default' and at 'high' (tools/torch_periodic_engines.py;
            # 1024^2: 2024-2430 against 1410-1763 steps/s at 'default';
            # 4096^2: 384-386 against 131) and level with it, host-bound,
            # at 256^2 and below, so 'auto' is fft at every size
            object.__setattr__(self, "transform", "fft")
            object.__setattr__(self, "compact_spectrum", False)
        if self.transform not in ("fft", "matmul"):
            raise ValueError(f"transform must be 'fft'|'matmul'|'auto', "
                             f"got {self.transform!r}")

    @property
    def real_dtype(self):
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def complex_dtype(self):
        return torch.complex128 if self.dtype == "float64" else torch.complex64


def _np_dtype(cfg: SpectralPeriodicConfig):
    return np.float64 if cfg.dtype == "float64" else np.float32


def _ik_mul(k: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """i * k * z for real k and complex z."""
    return torch.complex(-k * z.imag, k * z.real)


@device_table()
def _c2r_keep(ny: int, dtype: torch.dtype, device: torch.device):
    """1 on the ky columns whose imaginary part a C2R transform uses, 0 on
    ky = 0 and, for even ny, the Nyquist column."""
    keep = torch.ones(ny // 2 + 1, dtype=dtype)
    keep[0] = 0.0
    if ny % 2 == 0:
        keep[-1] = 0.0
    return keep.to(device)


def irfft2(z: torch.Tensor, s) -> torch.Tensor:
    """The real field of an rfft2-layout half spectrum (..., nx, ny//2+1)
    that need not be Hermitian, as numpy's irfft2 computes it: a complex
    inverse along x, then a C2R transform along y that drops the imaginary
    parts of the ky = 0 and Nyquist columns (which is also Re(gr @ Z @ gc)
    of a matmul-DFT inverse). cuFFT's two-dimensional C2R assumes Hermitian
    input and need not give that on other input (learned complex weights,
    i*k on the unpaired Nyquist modes), so the inverse is written as two
    one-dimensional transforms with those imaginary parts zeroed."""
    nx, ny = s
    t = torch.fft.ifft(z, n=nx, dim=-2)
    keep = _c2r_keep(ny, t.real.dtype, t.device)
    return torch.fft.irfft(torch.complex(t.real, t.imag * keep), n=ny, dim=-1)


# ---------------------------------------------------------------------------
# Layout and constants (host-side numpy, copied from the JAX module)
# ---------------------------------------------------------------------------

def _wavenumbers_np(cfg: SpectralPeriodicConfig):
    """kx (nx,1), ky (1, ny//2+1) integer wavenumbers, rfft2 layout."""
    kx = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)[:, None]
    ky = np.fft.rfftfreq(cfg.ny, d=1.0 / cfg.ny)[None, :]
    return kx, ky


def _dealias_mask(cfg: SpectralPeriodicConfig):
    """2/3-rule mask in the rfft2 layout."""
    kx = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)
    ky = np.fft.rfftfreq(cfg.ny, d=1.0 / cfg.ny)
    mx = np.abs(kx) < cfg.nx / 3.0
    my = np.abs(ky) < cfg.ny / 3.0
    return mx[:, None] & my[None, :]


def forcing_vorticity_np(cfg: SpectralPeriodicConfig):
    """Host-side (float64 numpy) vorticity-space forcing field f_w(x, y)
    on the 2*pi-periodic grid, or None when cfg.forcing == 'none'."""
    if cfg.forcing == "none":
        return None
    x = 2.0 * np.pi * np.arange(cfg.nx)[:, None] / cfg.nx
    y = 2.0 * np.pi * np.arange(cfg.ny)[None, :] / cfg.ny
    k, amp = cfg.forcing_k, cfg.forcing_amp
    if cfg.forcing == "kolmogorov":
        return -amp * k * np.cos(k * y) + 0.0 * x
    return amp * (np.sin(k * (x + y)) + np.cos(k * (x + y)))


def _forcing_hat_np(cfg: SpectralPeriodicConfig):
    """Forcing spectrum in the full rfft2 layout (complex128 host numpy),
    dealias-masked, mean mode exactly zero; None when unforced."""
    f = forcing_vorticity_np(cfg)
    if f is None:
        return None
    f_hat = np.fft.rfft2(f)
    if cfg.dealias:
        f_hat = np.where(_dealias_mask(cfg), f_hat, 0.0)
    f_hat[0, 0] = 0.0
    return f_hat


def _k_ops(cfg, kx, ky, device):
    """kx, ky, k2, inv_k2 and the viscous factor as tensors on `device`."""
    k2 = kx * kx + ky * ky
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    visc = np.exp(-cfg.nu * k2 * cfg.dt)
    as_t = lambda a: torch.as_tensor(a, dtype=cfg.real_dtype, device=device)
    return dict(kx=as_t(kx), ky=as_t(ky), k2=as_t(k2), inv_k2=as_t(inv_k2),
                visc=as_t(visc))


def make_ops(cfg: SpectralPeriodicConfig, device=None):
    """Spectral constants of the rfft2 layout on `device`: wavenumbers,
    1/k^2, the viscous factor, the dealias mask and, when forced, the
    forcing spectrum's real and imaginary parts (keys as in the JAX
    package)."""
    kx, ky = _wavenumbers_np(cfg)
    ops = _k_ops(cfg, kx, ky, device)
    mask = (_dealias_mask(cfg) if cfg.dealias
            else np.ones(ops["k2"].shape, bool))
    ops["mask"] = torch.as_tensor(mask, device=device)
    f_hat = _forcing_hat_np(cfg)
    if f_hat is not None:
        ops["f_re"] = torch.as_tensor(f_hat.real, dtype=cfg.real_dtype,
                                      device=device)
        ops["f_im"] = torch.as_tensor(f_hat.imag, dtype=cfg.real_dtype,
                                      device=device)
    return ops


def _compact_meta(cfg: SpectralPeriodicConfig):
    """(rows, kxc, n_neg, kyc) of the dealias-truncated compact layout."""
    kxs = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)
    keep_x = np.abs(kxs) < cfg.nx / 3.0
    kxc = int(keep_x[:cfg.nx // 2].sum())
    n_neg = int(keep_x.sum()) - kxc
    kyc = int((np.abs(np.fft.rfftfreq(cfg.ny, d=1.0 / cfg.ny))
               < cfg.ny / 3.0).sum())
    rows = np.concatenate([np.arange(kxc), np.arange(cfg.nx - n_neg, cfg.nx)])
    return rows, kxc, n_neg, kyc


def make_compact_ops(cfg: SpectralPeriodicConfig, device=None):
    """Spectral constants on the compact truncated layout (Rx, kyc); the
    rectangular truncation is the dealias mask, so no mask remains."""
    rows, kxc, n_neg, kyc = _compact_meta(cfg)
    kx = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)[rows][:, None]
    ky = np.fft.rfftfreq(cfg.ny, d=1.0 / cfg.ny)[:kyc][None, :]
    ops = _k_ops(cfg, kx, ky, device)
    del ops["k2"]
    f_hat = _forcing_hat_np(cfg)
    if f_hat is not None:
        f_c = np.concatenate([f_hat[:kxc, :kyc],
                              f_hat[cfg.nx - n_neg:, :kyc]], axis=0)
        ops["f_re"] = torch.as_tensor(f_c.real, dtype=cfg.real_dtype,
                                      device=device)
        ops["f_im"] = torch.as_tensor(f_c.imag, dtype=cfg.real_dtype,
                                      device=device)
    return ops


def _forcing(ops):
    """The forcing spectrum as one complex tensor, or None."""
    if "f_re" not in ops:
        return None
    return torch.complex(ops["f_re"], ops["f_im"])


# ---------------------------------------------------------------------------
# Transforms: FFT or DFT by GEMMs
# ---------------------------------------------------------------------------

def _dft_constants(cfg: SpectralPeriodicConfig):
    """Host-side DFT matrices (real/imaginary pairs in the config's numpy
    dtype) reproducing the rfft2 layout:

      forward:  w_hat = Fx @ (w @ Fy_half^T)
      inverse:  w     = Re[(conj(Fx)/nx @ z) @ B],  B[k,j] = c_k/ny e^{+2pi i kj/ny}

    with c_0 = c_{ny/2} = 1 and 2 otherwise (half-spectrum unfolding)."""
    nx, ny = cfg.nx, cfg.ny
    nyh = ny // 2 + 1
    i = np.arange(nx)
    Fx = np.exp(-2j * np.pi * np.outer(i, i) / nx)
    Fx_inv = np.conj(Fx) / nx
    k = np.arange(nyh)
    j = np.arange(ny)
    Fy = np.exp(-2j * np.pi * np.outer(k, j) / ny)        # (nyh, ny)
    c = np.full(nyh, 2.0)
    c[0] = 1.0
    if ny % 2 == 0:
        c[-1] = 1.0
    B = (c[:, None] / ny) * np.exp(2j * np.pi * np.outer(k, j) / ny)
    f = _np_dtype(cfg)
    split = lambda M: (M.real.astype(f), M.imag.astype(f))
    return dict(Fx=split(Fx), Fx_inv=split(Fx_inv), Fy=split(Fy), B=split(B))


def _table(cfg: SpectralPeriodicConfig, a: np.ndarray, device):
    """A constant GEMM operand on `device`, rounded once to bf16 where the
    float32 products run at 'default' (gemm.matmul then leaves it as it
    is: the same bits it would round it to on every call)."""
    t = torch.as_tensor(np.ascontiguousarray(a), dtype=cfg.real_dtype,
                        device=device)
    if cfg.dtype == "float32" and cfg.matmul_precision == "default":
        t = t.to(torch.bfloat16)
    return t


def _complex_dft(cfg: SpectralPeriodicConfig):
    """The DFT matrices of `_dft_constants` as complex128 (the float32
    engines' values rounded to float32 part by part, as the JAX package's)."""
    return {k: v[0].astype(np.float64) + 1j * v[1].astype(np.float64)
            for k, v in _dft_constants(cfg).items()}


def _interleaved_stages(cfg: SpectralPeriodicConfig, rows, kyc: int,
                        device):
    """The four GEMM stages (y_fwd, x_fwd, x_inv, y_inv) between physical
    (..., nx, ny) real fields and complex spectra (..., len(rows), kyc)
    holding the kx rows `rows` and the first kyc ky columns of the rfft2
    layout; a ky column is a pair of adjacent real columns (re, im) between
    the stages:

      y_fwd: t = w @ FyT_int               (n, 2kyc)   view_as_real(w @ Fy^T)
      x_fwd: P = [Fx_re; Fx_im] @ t        (2R, 2k)    -> z = Fx @ t
      x_inv: P = [Fxi_re; Fxi_im] @ view_as_real(z)    -> a = Fxi @ z (nx, 2k)
      y_inv: w = a @ B_int                 (n, ny)     Re(a @ B)

    FyT_int interleaves real and imaginary columns and B_int the rows
    (Re B, -Im B), so y_inv computes only the real part it returns. The x
    stages take any number k of ky columns (a rank's share of them in
    `parallel/spectral_sharded.py`, which moves them between the stages)."""
    M = _complex_dft(cfg)
    prec = cfg.matmul_precision
    nx, R = cfg.nx, len(rows)
    Fx = M["Fx"][rows, :]                                  # (R, nx)
    Fxi = M["Fx_inv"][:, rows]                             # (nx, R)
    FyT = M["Fy"][:kyc, :].T                               # (ny, kyc)
    B = M["B"][:kyc, :]                                    # (kyc, ny)
    FyT_int = _table(cfg, np.stack([FyT.real, FyT.imag], -1)
                     .reshape(cfg.ny, 2 * kyc), device)
    Fx_cat = _table(cfg, np.concatenate([Fx.real, Fx.imag]), device)
    Fxi_cat = _table(cfg, np.concatenate([Fxi.real, Fxi.imag]), device)
    B_int = _table(cfg, np.stack([B.real, -B.imag], 1)
                   .reshape(2 * kyc, cfg.ny), device)

    def combine(P, n):
        """(..., 2n, 2k) = [Re M; Im M] @ view_as_real(t) -> the real and
        imaginary parts of M @ t, each (..., n, k)."""
        P = P.unflatten(-2, (2, n)).unflatten(-1, (P.shape[-1] // 2, 2))
        re = P[..., 0, :, :, 0] - P[..., 1, :, :, 1]
        im = P[..., 0, :, :, 1] + P[..., 1, :, :, 0]
        return re, im

    def y_fwd(w):
        return matmul(w.to(cfg.real_dtype), FyT_int, prec)

    def x_fwd(t):
        return torch.complex(*combine(matmul(Fx_cat, t, prec), R))

    def x_inv(z):
        zr = torch.view_as_real(z.contiguous()).flatten(-2)  # (..., R, 2k)
        re, im = combine(matmul(Fxi_cat, zr, prec), nx)
        return torch.stack([re, im], -1).flatten(-2)

    def y_inv(a):
        return matmul(a, B_int, prec)

    return y_fwd, x_fwd, x_inv, y_inv


def _interleaved_transforms(cfg: SpectralPeriodicConfig, rows, kyc: int,
                            device):
    """(fwd, inv) of `_interleaved_stages`: two real GEMMs each way."""
    y_fwd, x_fwd, x_inv, y_inv = _interleaved_stages(cfg, rows, kyc, device)
    return lambda w: x_fwd(y_fwd(w)), lambda z: y_inv(x_inv(z))


def make_compact_stages(cfg: SpectralPeriodicConfig, device=None):
    """The compact transforms' four stages (`_interleaved_stages`) on the
    compact layout (Rx, kyc)."""
    rows, _, _, kyc = _compact_meta(cfg)
    return _interleaved_stages(cfg, rows, kyc, device)


def make_compact_transforms(cfg: SpectralPeriodicConfig, device=None):
    """(fwd, inv) between physical (..., nx, ny) and the compact spectrum
    (..., Rx, kyc): GEMMs only, no pad or scatter."""
    rows, _, _, kyc = _compact_meta(cfg)
    return _interleaved_transforms(cfg, rows, kyc, device)


def make_transforms(cfg: SpectralPeriodicConfig, device=None):
    """(rfft2_fn, irfft2_fn) per cfg.transform, both in the standard rfft2
    half-spectrum layout."""
    if cfg.transform == "fft":
        shape = (cfg.nx, cfg.ny)
        return (lambda w: torch.fft.rfft2(w),
                lambda z: torch.fft.irfft2(z, s=shape))
    if cfg.transform != "matmul":
        raise ValueError(
            f"transform must be fft|matmul, got {cfg.transform!r}")
    if not cfg.dealias:
        return _interleaved_transforms(cfg, np.arange(cfg.nx),
                                       cfg.ny // 2 + 1, device)
    # dealiased: the padded-layout transforms are the compact ones plus
    # the truncation (fwd returns mask * rfft2(w))
    cfwd, cinv = make_compact_transforms(cfg, device)
    return (lambda w: expand_compact(cfg, cfwd(w)),
            lambda z: cinv(gather_compact(cfg, z)))


def expand_compact(cfg: SpectralPeriodicConfig, z: torch.Tensor):
    """Compact (..., Rx, kyc) spectrum -> full rfft2 layout
    (..., nx, ny//2+1)."""
    _, kxc, n_neg, kyc = _compact_meta(cfg)
    out = torch.zeros(z.shape[:-2] + (cfg.nx, cfg.ny // 2 + 1),
                      dtype=z.dtype, device=z.device)
    out[..., :kxc, :kyc] = z[..., :kxc, :]
    out[..., cfg.nx - n_neg:, :kyc] = z[..., kxc:, :]
    return out


def gather_compact(cfg: SpectralPeriodicConfig, z: torch.Tensor):
    """Full rfft2 layout -> compact (..., Rx, kyc) (the kept modes)."""
    _, kxc, n_neg, kyc = _compact_meta(cfg)
    return torch.cat([z[..., :kxc, :kyc], z[..., cfg.nx - n_neg:, :kyc]],
                     dim=-2)


# ---------------------------------------------------------------------------
# Real-GEMM engine: stacked (2, Rx, kyc) real/imaginary carry
# ---------------------------------------------------------------------------

def _real_gemm_matrices(cfg: SpectralPeriodicConfig):
    """Block matrices of the stacked real/imag formulation (host numpy):

      fwd:  t2 = w @ FyT_cat             (nx, 2kyc)   [t_re | t_im]
            z2 = FX2 @ [t_re; t_im]      (2Rx, kyc)   [z_re; z_im]
      inv:  a2 = FXI2 @ [z_re; z_im]     (2nx, kyc)   [a_re; a_im]
            w  = [a_re | a_im] @ Bcat    (nx, ny)     Re(a @ B)
    """
    M = _complex_dft(cfg)
    rows, _, _, kyc = _compact_meta(cfg)
    Fx = M["Fx"][rows, :]
    Fx_inv = M["Fx_inv"][:, rows]
    Fy = M["Fy"][:kyc, :]
    B = M["B"][:kyc, :]
    FyT_cat = np.concatenate([Fy.real.T, Fy.imag.T], axis=1)       # (ny,2kyc)
    FX2 = np.block([[Fx.real, -Fx.imag],
                    [Fx.imag, Fx.real]])                           # (2Rx,2nx)
    FXI2 = np.block([[Fx_inv.real, -Fx_inv.imag],
                     [Fx_inv.imag, Fx_inv.real]])                  # (2nx,2Rx)
    Bcat = np.concatenate([B.real, -B.imag], axis=0)               # (2kyc,ny)
    return FyT_cat, FX2, FXI2, Bcat, len(rows), kyc


def make_real_gemm_transforms(cfg: SpectralPeriodicConfig, device=None):
    """(fwd, inv) between physical (..., nx, ny) real fields and stacked
    (..., 2, Rx, kyc) real/imag compact spectra: four real GEMMs per round
    trip, batched over leading dims."""
    FyT_cat, FX2, FXI2, Bcat, Rx, kyc = _real_gemm_matrices(cfg)
    FyT_cat, FX2, FXI2, Bcat = (_table(cfg, a, device)
                                for a in (FyT_cat, FX2, FXI2, Bcat))
    prec = cfg.matmul_precision
    nx = cfg.nx

    def fwd(w):
        t2 = matmul(w.to(cfg.real_dtype), FyT_cat, prec)  # (..., nx, 2kyc)
        tstack = torch.cat([t2[..., :kyc], t2[..., kyc:]], dim=-2)
        z2 = matmul(FX2, tstack, prec)                    # (..., 2Rx, kyc)
        return z2.unflatten(-2, (2, Rx))

    def inv(z2):
        a2 = matmul(FXI2, z2.flatten(-3, -2), prec)       # (..., 2nx, kyc)
        acat = torch.cat([a2[..., :nx, :], a2[..., nx:, :]], dim=-1)
        return matmul(acat, Bcat, prec)                   # (..., nx, ny)

    return fwd, inv


def _ik_mul2(k: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """i * k * z on the stacked (..., 2, Rx, kyc) layout:
    (re, im) -> (-k*im, k*re)."""
    return torch.stack([-k * z2[..., 1, :, :], k * z2[..., 0, :, :]], dim=-3)


def compact_real_to_complex(z2: torch.Tensor) -> torch.Tensor:
    """Stacked (..., 2, Rx, kyc) real pair -> compact complex spectrum."""
    return torch.complex(z2[..., 0, :, :], z2[..., 1, :, :])


# ---------------------------------------------------------------------------
# Physics: nonlinear term, IF-AB2 step
# ---------------------------------------------------------------------------

def _derivative_factors(ops) -> torch.Tensor:
    """(4, R, K) complex factors taking w_hat to the spectra of
    (u, v, dw/dx, dw/dy): i*ky/k^2, -i*kx/k^2, i*kx, i*ky."""
    kx, ky, inv_k2 = ops["kx"], ops["ky"], ops["inv_k2"]
    shape = torch.broadcast_shapes(kx.shape, ky.shape)
    k4 = torch.stack([(ky * inv_k2).expand(shape), (-kx * inv_k2).expand(
        shape), kx.expand(shape), ky.expand(shape)])
    return torch.complex(torch.zeros_like(k4), k4)


def _nonlinear_compact(ops, fwd, inv, w_hat):
    """-FFT[u.grad(w)] (+ forcing) on a complex layout whose transforms
    are (fwd, inv); the four inverse transforms ride one batched GEMM
    pair. `ops` carries "d4" (_derivative_factors) and "f_hat"."""
    u, v, wx, wy = inv(ops["d4"] * w_hat.unsqueeze(-3)).unbind(-3)
    N = -fwd(u * wx + v * wy)
    if ops.get("f_hat") is not None:
        N = N + ops["f_hat"]
    return N


def _nonlinear_real(ops, fwd, inv, w2):
    """Stacked real/imag (real_gemm) counterpart of _nonlinear_compact."""
    psi = w2 * ops["inv_k2"]
    stack = torch.stack([_ik_mul2(ops["ky"], psi), _ik_mul2(-ops["kx"], psi),
                         _ik_mul2(ops["kx"], w2), _ik_mul2(ops["ky"], w2)],
                        dim=-4)
    u, v, wx, wy = inv(stack).unbind(-3)
    N = -fwd(u * wx + v * wy)
    if "f_re" in ops:
        N = N + torch.stack([ops["f_re"], ops["f_im"]], dim=-3)
    return N


def velocity_from_vorticity_hat(w_hat: torch.Tensor, ops):
    """u = d(psi)/dy, v = -d(psi)/dx with psi_hat = w_hat / k^2."""
    psi_hat = w_hat * ops["inv_k2"]
    return _ik_mul(ops["ky"], psi_hat), -_ik_mul(ops["kx"], psi_hat)


def nonlinear_term(w_hat: torch.Tensor, ops, cfg, transforms=None):
    """N_hat = -FFT[u dw/dx + v dw/dy], dealiased (pseudospectral), in the
    rfft2 layout."""
    fwd, inv = (transforms if transforms is not None
                else make_transforms(cfg, w_hat.device))
    w_hat = torch.where(ops["mask"], w_hat, 0.0)
    u_hat, v_hat = velocity_from_vorticity_hat(w_hat, ops)
    spectra = torch.stack([u_hat, v_hat, _ik_mul(ops["kx"], w_hat),
                           _ik_mul(ops["ky"], w_hat)], dim=-3)
    u, v, wx, wy = inv(spectra).unbind(-3)
    N_hat = -fwd(u * wx + v * wy)
    if "f_re" in ops:
        N_hat = N_hat + torch.complex(ops["f_re"], ops["f_im"])
    return torch.where(ops["mask"], N_hat, 0.0)


def _if_ab2(cfg: SpectralPeriodicConfig, E: torch.Tensor, nonlinear):
    """step(carry) -> (new_carry, w_new) of the IF-AB2 scheme

      w^{n+1} = E w^n + dt (3/2 E N^n - 1/2 E^2 N^{n-1}),  E = e^{-nu k^2 dt}

    with the factors 3/2 E and 1/2 E^2 taken once (the same values the
    JAX expression computes each step)."""
    c1, c2 = 1.5 * E, 0.5 * (E * E)

    def step(carry):
        w, N_prev = carry
        N = nonlinear(w)
        w_new = E * w + cfg.dt * (c1 * N - c2 * N_prev)
        return (w_new, N), w_new

    return step


def _engine(cfg: SpectralPeriodicConfig, device):
    """(fwd, nonlinear, ops) of cfg's engine on `device`: the forward
    transform of a physical field into the carry's layout, the nonlinear
    term on that layout, and the layout's constants. Raises the JAX
    package's errors for engine combinations it refuses. Cached per
    (config, device), as the JAX package's jit caches its programs: the
    module-level rollouts then build their DFT tables once, not on every
    call. Nothing in an engine depends on nt, so configs that differ only
    in nt share one entry."""
    return _engine_cached(dataclasses.replace(cfg, nt=0), device)


@device_table(maxsize=4)
def _engine_cached(cfg: SpectralPeriodicConfig, device):
    if cfg.real_gemm:
        if not (cfg.transform == "matmul" and cfg.dealias
                and cfg.compact_spectrum):
            raise ValueError("real_gemm needs transform='matmul', "
                             "dealias=True and compact_spectrum=True")
        ops = make_compact_ops(cfg, device)
        fwd, inv = make_real_gemm_transforms(cfg, device)
        return fwd, lambda w2: _nonlinear_real(ops, fwd, inv, w2), ops
    if cfg.compact_spectrum:
        if cfg.transform != "matmul" or not cfg.dealias:
            raise ValueError("compact_spectrum needs transform='matmul' "
                             "and dealias")
        ops = make_compact_ops(cfg, device)
        fwd, inv = make_compact_transforms(cfg, device)
        ops["d4"] = _derivative_factors(ops)
        ops["f_hat"] = _forcing(ops)
        return fwd, lambda w: _nonlinear_compact(ops, fwd, inv, w), ops
    ops = make_ops(cfg, device)
    transforms = make_transforms(cfg, device)
    return (transforms[0],
            lambda w: nonlinear_term(w, ops, cfg, transforms), ops)


def make_step_compact_real(cfg: SpectralPeriodicConfig, device=None):
    """IF-AB2 step on the stacked real compact carry (real_gemm engine)."""
    _, nonlinear, ops = _engine(cfg, device)
    return _if_ab2(cfg, ops["visc"], nonlinear), ops


def make_step_compact(cfg: SpectralPeriodicConfig, device=None):
    """IF-AB2 step on the compact spectrum carry (matmul + dealias only)."""
    if cfg.transform != "matmul" or not cfg.dealias:
        raise ValueError("compact_spectrum needs transform='matmul' and "
                         "dealias")
    cfg = dataclasses.replace(cfg, compact_spectrum=True, real_gemm=False)
    _, nonlinear, ops = _engine(cfg, device)
    return _if_ab2(cfg, ops["visc"], nonlinear), ops


def make_step(cfg: SpectralPeriodicConfig, device=None):
    """One IF-AB2 step on (w_hat, N_prev_hat) for cfg's engine. Returns
    (step, ops); step(carry) -> (new_carry, w_new)."""
    _, nonlinear, ops = _engine(cfg, device)
    return _if_ab2(cfg, ops["visc"], nonlinear), ops


# ---------------------------------------------------------------------------
# Init / rollouts
# ---------------------------------------------------------------------------

def _as_vorticity(cfg: SpectralPeriodicConfig, w0, device=None):
    """w0 as a real tensor on `device`. With device None a tensor stays on
    its own device and host data goes to CUDA (core/device.py)."""
    if isinstance(w0, torch.Tensor):
        return w0.to(device=device or w0.device, dtype=cfg.real_dtype)
    return torch.as_tensor(np.asarray(w0), dtype=cfg.real_dtype,
                           device=resolve_device(device))


def _carry_builder(cfg: SpectralPeriodicConfig, device):
    """w0 -> carry for any engine, its constants built once: the forward
    transform, the AB2 history self-started with the first nonlinear
    evaluation."""
    fwd, nonlinear, _ = _engine(cfg, device)

    def build(w0):
        w_hat = fwd(w0.to(cfg.real_dtype))
        return w_hat, nonlinear(w_hat)

    return build


def carry_from_vorticity(cfg: SpectralPeriodicConfig, w0: torch.Tensor):
    """Carry for any engine (fft / matmul / compact / real_gemm) from a
    physical vorticity tensor, on its device."""
    return _carry_builder(cfg, w0.device)(w0)


def init_from_vorticity(cfg: SpectralPeriodicConfig, w0, device=None):
    """Carry from a vorticity given as numpy or torch, on `device` (default:
    the tensor's own, or CUDA for numpy; core/device.py). With
    cfg.compact_spectrum the carry is the compact truncated spectrum."""
    return carry_from_vorticity(cfg, _as_vorticity(cfg, w0, device))


def init_from_vorticity_compact(cfg: SpectralPeriodicConfig, w0,
                                device=None):
    """init_from_vorticity on the compact complex engine."""
    if not cfg.compact_spectrum or cfg.real_gemm:
        cfg = dataclasses.replace(cfg, compact_spectrum=True, real_gemm=False)
    return init_from_vorticity(cfg, w0, device)


def init_from_vorticity_real(cfg: SpectralPeriodicConfig, w0, device=None):
    """init_from_vorticity on the real_gemm engine."""
    if not cfg.real_gemm:
        cfg = dataclasses.replace(cfg, compact_spectrum=True, real_gemm=True)
    return init_from_vorticity(cfg, w0, device)


def make_inverse(cfg: SpectralPeriodicConfig, device=None):
    """Spectrum in the carry's layout -> physical vorticity on `device`,
    its tables built once."""
    if cfg.real_gemm:
        return make_real_gemm_transforms(cfg, device)[1]
    if cfg.compact_spectrum:
        return make_compact_transforms(cfg, device)[1]
    return lambda z: torch.fft.irfft2(z, s=(cfg.nx, cfg.ny))


def physical_from_carry(cfg: SpectralPeriodicConfig, w_spec: torch.Tensor):
    """Spectrum in the carry's layout -> physical vorticity."""
    return make_inverse(cfg, w_spec.device)(w_spec)


def _advance(step, carry, n: int):
    """`n` steps from `carry`; the final carry."""
    for _ in range(n):
        carry, _ = step(carry)
    return carry


def simulate_hat(cfg: SpectralPeriodicConfig, carry0) -> torch.Tensor:
    """Rollout returning the stacked vorticity spectra (nt, ...) in the
    carry's layout."""
    step, _ = make_step(cfg, carry0[0].device)
    out = torch.empty((cfg.nt, *carry0[0].shape), dtype=carry0[0].dtype,
                      device=carry0[0].device)
    carry = carry0
    for n in range(cfg.nt):
        carry, out[n] = step(carry)
    return out


def rollout_final(cfg: SpectralPeriodicConfig, carry0):
    """Rollout of cfg.nt steps returning only the final carry."""
    step, _ = make_step(cfg, carry0[0].device)
    return _advance(step, carry0, cfg.nt)


def rollout_final_compact(cfg: SpectralPeriodicConfig, carry0):
    """rollout_final on the compact complex engine (bench.py's rollout)."""
    step, _ = make_step_compact(cfg, carry0[0].device)
    return _advance(step, carry0, cfg.nt)


def _to_full(cfg: SpectralPeriodicConfig, z: torch.Tensor) -> torch.Tensor:
    """A spectrum in the carry's layout -> the complex rfft2 layout."""
    if cfg.real_gemm:
        z = compact_real_to_complex(z)
    if cfg.compact_spectrum:
        z = expand_compact(cfg, z)
    return z


def fields_from_hat(cfg: SpectralPeriodicConfig, w_hat: torch.Tensor):
    """(u, v, omega) physical fields from an rfft2-layout spectrum."""
    ops = make_ops(cfg, w_hat.device)
    u_hat, v_hat = velocity_from_vorticity_hat(w_hat, ops)
    u, v, w = torch.fft.irfft2(torch.stack([u_hat, v_hat, w_hat], dim=-3),
                               s=(cfg.nx, cfg.ny)).unbind(-3)
    return u, v, w


def _uvp(cfg: SpectralPeriodicConfig, ops, w_hat: torch.Tensor):
    """(u, v, p) from an rfft2-layout spectrum: Lap(p) = -rho div(u.grad u)
    by the diagonal inverse Laplacian, the six inverse transforms as one
    batched irfft2."""
    shape = (cfg.nx, cfg.ny)
    u_hat, v_hat = velocity_from_vorticity_hat(w_hat, ops)
    kx, ky = ops["kx"], ops["ky"]
    u, v, ux, uy, vx, vy = torch.fft.irfft2(torch.stack(
        [u_hat, v_hat, _ik_mul(kx, u_hat), _ik_mul(ky, u_hat),
         _ik_mul(kx, v_hat), _ik_mul(ky, v_hat)], dim=-3), s=shape).unbind(-3)
    rhs = -cfg.rho * (ux * ux + 2.0 * uy * vx + vy * vy)
    p_hat = -torch.fft.rfft2(rhs) * ops["inv_k2"]
    return u, v, torch.fft.irfft2(p_hat, s=shape)


def pressure_from_hat(cfg: SpectralPeriodicConfig, w_hat: torch.Tensor):
    """Recover pressure from the velocity field: Lap(p) = -rho div(u.grad u),
    the periodic analogue of the reference's pressure-Poisson solve."""
    return _uvp(cfg, make_ops(cfg, w_hat.device), w_hat)[2]


def make_extractor(cfg: SpectralPeriodicConfig, device=None):
    """Carry spectrum -> (u, v, p) on `device`, with its constants built
    once (the per-frame extraction of the rollouts)."""
    ops = make_ops(cfg, device)
    return lambda z: _uvp(cfg, ops, _to_full(cfg, z))


def simulate_strided(cfg: SpectralPeriodicConfig, w0, n_frames: int,
                     stride: int = 1, spinup: int = 0, device=None):
    """Strided rollout from a physical vorticity field: (u, v, p) stacked
    (n_frames, nx, ny), materializing only the saved frames. Frame i is the
    state after 1 + spinup + i*stride steps, so stride=1, spinup=0
    reproduces simulate()'s frames. Works on every engine. The rollout
    runs on `device` (default: w0's own, or CUDA for numpy)."""
    w0 = _as_vorticity(cfg, w0, device)
    step, _ = make_step(cfg, w0.device)
    return _strided(cfg, step, make_extractor(cfg, w0.device),
                    carry_from_vorticity(cfg, w0), n_frames, stride, spinup)


def _strided(cfg, step, extract, carry, n_frames, stride, spinup):
    frames = torch.empty((3, n_frames, cfg.nx, cfg.ny), dtype=cfg.real_dtype,
                         device=carry[0].device)
    carry = _advance(step, carry, 1 + spinup)
    for i in range(n_frames):
        if i:
            carry = _advance(step, carry, stride)
        for j, f in enumerate(extract(carry[0])):
            frames[j, i] = f
    return tuple(frames)


# ---------------------------------------------------------------------------
# Initial conditions (host-side numpy: seeded, reproducible, bitwise equal
# to the JAX package's for the same seed)
# ---------------------------------------------------------------------------

def taylor_green_vorticity(cfg: SpectralPeriodicConfig, k: int = 1):
    """Taylor-Green vortex: u = sin(kx)cos(ky), v = -cos(kx)sin(ky)
    -> omega = 2k sin(kx) sin(ky). Analytic decay exp(-2 nu k^2 t)."""
    x = np.arange(cfg.nx) * 2.0 * np.pi / cfg.nx
    y = np.arange(cfg.ny) * 2.0 * np.pi / cfg.ny
    X, Y = np.meshgrid(x, y, indexing="ij")
    return (2.0 * k * np.sin(k * X) * np.sin(k * Y)).astype(_np_dtype(cfg))


def decaying_turbulence_vorticity(cfg: SpectralPeriodicConfig, seed: int = 0,
                                  k_peak: float = 10.0):
    """Random isotropic vorticity with energy peaked near k_peak (the
    standard 2D decaying-turbulence initial condition), normalised to unit
    max vorticity."""
    rng = np.random.default_rng(seed)
    kx = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)
    ky = np.fft.rfftfreq(cfg.ny, d=1.0 / cfg.ny)
    k = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    amp = k**3 * np.exp(-0.5 * (k / k_peak) ** 2)
    phase = rng.uniform(0.0, 2 * np.pi, size=amp.shape)
    w_hat = amp * np.exp(1j * phase)
    w = np.fft.irfft2(w_hat, s=(cfg.nx, cfg.ny))
    w = w / np.abs(w).max()
    return w.astype(_np_dtype(cfg))


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def hermitian_weights(ny: int) -> np.ndarray:
    """Conjugate-pair weights of the rfft half-spectrum: interior ky modes
    represent two full-spectrum modes and count twice."""
    weights = np.full(ny // 2 + 1, 2.0)
    weights[0] = 1.0
    if ny % 2 == 0:
        weights[-1] = 1.0
    return weights[None, :]


def energy_spectrum(cfg: SpectralPeriodicConfig, w_hat: torch.Tensor):
    """Isotropic kinetic-energy spectrum E(k) of an rfft2-layout spectrum:
    (k_bins, E)."""
    ops = make_ops(cfg, w_hat.device)
    u_hat, v_hat = velocity_from_vorticity_hat(w_hat, ops)
    w = torch.as_tensor(hermitian_weights(cfg.ny), dtype=cfg.real_dtype,
                        device=w_hat.device)
    e_density = 0.5 * (u_hat.abs() ** 2 + v_hat.abs() ** 2) * w
    k_mag = torch.sqrt(ops["kx"] ** 2 + ops["ky"] ** 2)
    nbins = cfg.nx // 2 + 1
    k_idx = torch.clamp(torch.round(k_mag).to(torch.int64), 0, nbins - 1)
    spec = torch.zeros(nbins, dtype=cfg.real_dtype, device=w_hat.device)
    spec.index_add_(0, k_idx.expand(e_density.shape).reshape(-1),
                    e_density.reshape(-1))
    return (torch.arange(nbins, device=w_hat.device),
            spec / (cfg.nx * cfg.ny) ** 2)


def divergence_max(cfg: SpectralPeriodicConfig, w_hat: torch.Tensor):
    """Max |div u| of an rfft2-layout spectrum: ~0 by construction
    (streamfunction form)."""
    ops = make_ops(cfg, w_hat.device)
    u_hat, v_hat = velocity_from_vorticity_hat(w_hat, ops)
    div_hat = _ik_mul(ops["kx"], u_hat) + _ik_mul(ops["ky"], v_hat)
    return torch.max(torch.abs(torch.fft.irfft2(div_hat,
                                                s=(cfg.nx, cfg.ny))))


# ---------------------------------------------------------------------------
# Family-standard API wrapper
# ---------------------------------------------------------------------------

class NavierStokesSystem:
    """API wrapper matching the other families: simulate() -> (u, v, p)
    stacked (nt, nx, ny) rollouts on `device` (default CUDA, whatever w_ic
    is; core/device.py). The step, the carry builder and the extraction
    constants are built once, as the JAX wrapper compiles its programs
    once, and serve every initial condition."""

    def __init__(self, w_ic, nt=200, nx=256, ny=256, dt=0.001, nu=1e-3,
                 rho=1.0, dealias=True, dtype="float32", transform="fft",
                 matmul_precision="high", compact_spectrum=False,
                 real_gemm=False, forcing="none", forcing_k=4,
                 forcing_amp=0.1, device=None):
        self.cfg = SpectralPeriodicConfig(
            nt=nt, nx=nx, ny=ny, dt=dt, nu=nu, rho=rho, dealias=dealias,
            dtype=dtype, transform=transform,
            matmul_precision=matmul_precision,
            compact_spectrum=compact_spectrum or real_gemm,
            real_gemm=real_gemm, forcing=forcing, forcing_k=forcing_k,
            forcing_amp=forcing_amp)
        self.device = resolve_device(device)
        self._w_ic = _as_vorticity(self.cfg, w_ic, self.device)
        self._carry = _carry_builder(self.cfg, self.device)
        self._step, _ = make_step(self.cfg, self.device)
        self._extract = make_extractor(self.cfg, self.device)
        self.carry0 = self._carry(self._w_ic)

    def _as_w(self, w_ic):
        return _as_vorticity(self.cfg, w_ic, self.device)

    def simulate(self):
        return self.simulate_from_carry(self.carry0)

    def simulate_from(self, w_ic):
        """simulate() from another initial vorticity, reusing this
        instance's constants."""
        return self.simulate_from_carry(self._carry(self._as_w(w_ic)))

    def simulate_from_carry(self, carry0):
        """Every step's (u, v, p), each (nt, nx, ny); a frame's fields are
        extracted right after its step."""
        cfg = self.cfg
        out = torch.empty((3, cfg.nt, cfg.nx, cfg.ny), dtype=cfg.real_dtype,
                          device=self.device)
        carry = carry0
        for n in range(cfg.nt):
            carry, w = self._step(carry)
            for j, f in enumerate(self._extract(w)):
                out[j, n] = f
        return tuple(out)

    def simulate_strided(self, n_frames, stride=1, spinup=0, w_ic=None):
        """Strided, spun-up (u, v, p) rollout (module-level
        simulate_strided's frame semantics) from w_ic or this system's
        initial vorticity."""
        w = self._w_ic if w_ic is None else self._as_w(w_ic)
        return _strided(self.cfg, self._step, self._extract, self._carry(w),
                        n_frames, stride, spinup)

    def simulate_vorticity(self):
        """Every step's physical vorticity, (nt, nx, ny)."""
        cfg = self.cfg
        out = torch.empty((cfg.nt, cfg.nx, cfg.ny), dtype=cfg.real_dtype,
                          device=self.device)
        carry = self.carry0
        for n in range(cfg.nt):
            carry, w = self._step(carry)
            out[n] = torch.fft.irfft2(_to_full(cfg, w), s=(cfg.nx, cfg.ny))
        return out

    def final_state(self):
        """The carry after cfg.nt steps from carry0 (rollout_final)."""
        return _advance(self._step, self.carry0, self.cfg.nt)


# ---------------------------------------------------------------------------
# The carry across packages
# ---------------------------------------------------------------------------

def carry_to_numpy(carry) -> tuple[np.ndarray, np.ndarray]:
    """A carry (w_hat, N_prev) from either package as numpy arrays."""
    conv = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))
    return conv(carry[0]), conv(carry[1])


def carry_from_numpy(cfg: SpectralPeriodicConfig, carry, device=None):
    """Inverse of `carry_to_numpy`: numpy arrays onto `device` (CUDA for
    None, core/device.py) in the config's dtype (real for the real_gemm
    engine's stacked carry, complex otherwise)."""
    dtype = cfg.real_dtype if cfg.real_gemm else cfg.complex_dtype
    device = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in carry)
