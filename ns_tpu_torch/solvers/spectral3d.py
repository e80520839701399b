"""3D periodic Fourier pseudospectral Navier-Stokes (the DNS family).

Port of `ns_tpu/solvers/spectral3d.py`. Incompressible NSE on [0, 2*pi)^3
in velocity form with the rotational (Lamb-vector) nonlinearity and exact
Leray projection:

    du/dt = P[u x omega] - nu k^2 u (+ f),   P(k) = I - k k^T / k^2

Time integration: integrating factor exp(-nu k^2 dt) for the viscous term
plus Adams-Bashforth-2 for the projected nonlinear term. The carry is
(u_hat, N_prev): the velocity spectrum (3, nx, ny, nz//2+1) in rfftn layout
under the fft engine, or the dealias-truncated compact layout (3, Rx, Ry,
Kzc) under the matmul engine.

Engines:
  - 'fft': `torch.fft.rfftn`/`irfftn` (cuFFT on the card).
  - 'matmul': per-axis DFT GEMMs on the compact spectrum, at
    `matmul_precision` ('highest' and 'high' fp32, 'default' bf16 inputs;
    `ops/gemm.py`).
  - `use_pallas_transform` (the name kept from the JAX package): the
    matmul engine's z and y stages run as the fused kernels K6
    (`fused_zy_forward`) and K7 (`fused_yz_inverse`), and the nonlinear
    term's whole physical leg as K8 (`fused_lamb`), one call per step
    (`ops/kernels/transform3d_kernels.py`). All three follow
    `matmul_precision` as the JAX kernels do (bf16 tensor cores at
    'default', fp32 at 'high' and 'highest'). On a
    CPU tensor the wrappers run their plain twins, so the fused route runs
    there too.

The host-side layout helpers, DFT constants and initial conditions are
numpy copies of the JAX module's (that module imports jax), so the same
seed gives bitwise-equal inputs in both packages. Rollouts are Python loops
of `step` on the carry's device.

The host-side constants (`make_ops`, `_dft_tables`, `_hermitian_weights`:
float64 numpy, then pageable copies to the device, which wait for the
stream) are built once per (config with nt = 0, device) and shared by every
caller through `ops/cache.py::device_table`, as the 2D family's engines
are; `constants_cache_info()` reports their hits and misses. Callers get
the cached tensors themselves (the CUDA graphs of
`runtime/engine.py::Rollout3DEngine` capture them) and never write into
them.

Trace spans (`utils/profiling.py::named_scope`, free when no profiler
runs): `spectral3d.constants` around each host-side constant build, so it
opens on a cache miss only (none nests in another), and
`spectral3d.nonlinear` around `nonlinear_term`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.ops.cache import device_table
from ns_tpu_torch.ops.gemm import cmatmul
from ns_tpu_torch.ops.kernels import transform3d_kernels as t3k
from ns_tpu_torch.solvers.spectral_periodic import _c2r_keep
from ns_tpu_torch.utils.profiling import named_scope

CONSTANTS_SPAN = "spectral3d.constants"
NONLINEAR_SPAN = "spectral3d.nonlinear"


def _ik_mul(k: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """i * k * z for real k and complex z."""
    return torch.complex(-k * z.imag, k * z.real)


def irfft3(z: torch.Tensor, s) -> torch.Tensor:
    """The real field of an rfftn-layout half spectrum (..., nx, ny,
    nz//2+1) that need not be Hermitian, as numpy's irfftn computes it: a
    complex inverse along x and y, then a C2R transform along z that drops
    the imaginary parts of the kz = 0 and Nyquist planes. The 3D
    counterpart of `spectral_periodic.irfft2`: cuFFT's multi-dimensional
    C2R assumes Hermitian input, which learned complex weights and i*k on
    the unpaired Nyquist modes do not give. On a Hermitian spectrum it
    equals `torch.fft.irfftn` (bitwise on the CPU)."""
    nx, ny, nz = s
    t = torch.fft.ifftn(z, s=(nx, ny), dim=(-3, -2))
    keep = _c2r_keep(nz, t.real.dtype, t.device)
    return torch.fft.irfft(torch.complex(t.real, t.imag * keep), n=nz, dim=-1)


@dataclasses.dataclass(frozen=True)
class Spectral3DConfig:
    nt: int = 100
    nx: int = 64
    ny: int = 64
    nz: int = 64
    dt: float = 1e-3
    nu: float = 6.25e-4  # 1/1600: the canonical TGV Reynolds number
    rho: float = 1.0
    dealias: bool = True
    dtype: str = "float32"  # 'float32' | 'float64'
    # 'fft': rfftn. 'matmul': per-axis DFT GEMMs on the compact
    # dealias-truncated spectrum (requires dealias=True). 'auto': matmul
    # under AUTO_FFT_CROSSOVER and dealiased, fft otherwise.
    transform: str = "fft"
    matmul_precision: str = "high"  # 'default' (bf16) | 'high' | 'highest'
    # Constant-in-time body forcing (velocity space):
    #   'none'        unforced decaying turbulence
    #   'kolmogorov'  f = (amp*sin(k*y), 0, 0); laminar fixed point
    #                 u_s = amp/(nu k^2) * sin(k*y) x_hat
    forcing: str = "none"
    forcing_k: int = 4
    forcing_amp: float = 0.1

    # Fused z+y transform kernels K6-K8 (module docstring): matmul engine
    # and float32 only. 'auto' keeps the JAX package's policy, with the
    # card's crossover: fuse iff matmul engine, float32, matmul_precision
    # == 'default', volume >= PALLAS_FUSE_CROSSOVER^3, and the kernels'
    # blocks fit shared memory.
    # pallas_interpret is accepted for parity with the JAX config and has
    # no meaning here (there is no interpreter mode: a CPU tensor takes the
    # kernels' plain twins).
    use_pallas_transform: bool | str = False
    pallas_interpret: bool = False

    # AUTO_FFT_CROSSOVER is the JAX package's, measured on a TPU v5e and
    # kept for parity; it is to be re-measured on the H100 (ROADMAP.md).
    # PALLAS_FUSE_CROSSOVER is the H100's (the JAX package has 256): at
    # 'default' the fused step loop ran 2.9-3.2x the plain one at 128^3 and
    # 1.8x at 256^3 (tools/torch_fuse_crossover.py; PERF.md); smaller grids
    # are unmeasured.
    AUTO_FFT_CROSSOVER = 2048
    PALLAS_FUSE_CROSSOVER = 128

    def __post_init__(self):
        if self.forcing not in ("none", "kolmogorov"):
            raise ValueError(
                f"forcing must be 'none'|'kolmogorov', got {self.forcing!r}")
        if self.forcing != "none" and self.forcing_k < 1:
            raise ValueError(f"forcing_k must be >= 1, got {self.forcing_k}")
        if self.transform == "auto":
            if (max(self.nx, self.ny, self.nz) < self.AUTO_FFT_CROSSOVER
                    and self.dealias):
                object.__setattr__(self, "transform", "matmul")
            else:
                object.__setattr__(self, "transform", "fft")
        if self.transform not in ("fft", "matmul"):
            raise ValueError(f"transform must be 'fft'|'matmul'|'auto', "
                             f"got {self.transform!r}")
        if self.transform == "matmul" and not self.dealias:
            raise ValueError("transform='matmul' carries the dealias-"
                             "truncated compact spectrum and needs "
                             "dealias=True")
        if self.use_pallas_transform == "auto":
            on = (self.transform == "matmul" and self.dtype == "float32"
                  and self.matmul_precision == "default"
                  and self.nx * self.ny * self.nz
                  >= self.PALLAS_FUSE_CROSSOVER**3
                  and self._fused_fits_smem())
            object.__setattr__(self, "use_pallas_transform", on)
        elif not isinstance(self.use_pallas_transform, bool):
            raise ValueError(
                "use_pallas_transform must be a bool or 'auto'; got "
                f"{self.use_pallas_transform!r}")
        if self.use_pallas_transform and (self.transform != "matmul"
                                          or self.dtype != "float32"):
            raise ValueError(
                "use_pallas_transform fuses the compact matmul engine's "
                "z+y stages and needs transform='matmul' + "
                "dtype='float32' (the kernels are float32)")
        if self.use_pallas_transform and not self._fused_fits_smem():
            raise ValueError(
                f"use_pallas_transform=True at ({self.nx}, {self.ny}, "
                f"{self.nz}): a fused kernel's block exceeds one Hopper "
                "block's shared memory (transform3d_kernels.fused_fits); "
                "use the einsum engine (use_pallas_transform=False)")

    def _fused_fits_smem(self) -> bool:
        """Whether the fused kernels' blocks fit shared memory at this
        matmul_precision (each kernel has its own at 'default': bf16; and
        at 'high'/'highest': 3xTF32 for K6, K7 and K8)."""
        _, rows_y, kzc = _compact_meta(self)
        return t3k.fused_fits(self.nx, self.ny, self.nz, len(rows_y), kzc,
                              self.matmul_precision)

    @property
    def real_dtype(self):
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def complex_dtype(self):
        return torch.complex128 if self.dtype == "float64" else torch.complex64

    @property
    def compact(self) -> bool:
        """The matmul engine always carries the compact spectrum."""
        return self.transform == "matmul"


# ---------------------------------------------------------------------------
# Layout metadata (host-side numpy, copied from the JAX module)
# ---------------------------------------------------------------------------

def _axis_freqs(n: int, half: bool) -> np.ndarray:
    return (np.fft.rfftfreq if half else np.fft.fftfreq)(n, d=1.0 / n)


def _kept_rows(n: int, half: bool) -> np.ndarray:
    """Indices kept by the 2/3 rule along one axis (full-FFT axes keep a
    positive block + a negative tail; the rfft axis keeps a leading block)."""
    k = _axis_freqs(n, half)
    keep = np.abs(k) < n / 3.0
    return np.nonzero(keep)[0]


def _compact_meta(cfg: Spectral3DConfig):
    """(rows_x, rows_y, kzc) of the truncated compact layout."""
    rows_x = _kept_rows(cfg.nx, half=False)
    rows_y = _kept_rows(cfg.ny, half=False)
    kzc = len(_kept_rows(cfg.nz, half=True))
    return rows_x, rows_y, kzc


def _wavenumbers_np(cfg: Spectral3DConfig):
    """kx (nx,1,1), ky (1,ny,1), kz (1,1,nzh) for the full rfftn layout,
    truncated to the kept rows under the compact (matmul) layout."""
    kx = _axis_freqs(cfg.nx, half=False)
    ky = _axis_freqs(cfg.ny, half=False)
    kz = _axis_freqs(cfg.nz, half=True)
    if cfg.compact:
        rows_x, rows_y, kzc = _compact_meta(cfg)
        kx, ky, kz = kx[rows_x], ky[rows_y], kz[:kzc]
    return kx[:, None, None], ky[None, :, None], kz[None, None, :]


def _dealias_mask_np(cfg: Spectral3DConfig):
    """2/3-rule mask in the full rfftn layout (fft engine only; the compact
    layout's truncation plays this role structurally)."""
    mx = np.abs(_axis_freqs(cfg.nx, False)) < cfg.nx / 3.0
    my = np.abs(_axis_freqs(cfg.ny, False)) < cfg.ny / 3.0
    mz = np.abs(_axis_freqs(cfg.nz, True)) < cfg.nz / 3.0
    return mx[:, None, None] & my[None, :, None] & mz[None, None, :]


def forcing_velocity_np(cfg: Spectral3DConfig):
    """Host-side physical forcing field (3, nx, ny, nz) or None."""
    if cfg.forcing == "none":
        return None
    y = 2.0 * np.pi * np.arange(cfg.ny) / cfg.ny
    f = np.zeros((3, cfg.nx, cfg.ny, cfg.nz))
    f[0] = (cfg.forcing_amp * np.sin(cfg.forcing_k * y))[None, :, None]
    return f


def _forcing_hat_np(cfg: Spectral3DConfig):
    """Forcing spectrum (3, ...) in the active layout (complex128 host
    numpy), dealias-masked, mean pinned to zero; None when unforced.
    The Kolmogorov force is already solenoidal (div f = 0), so no
    projection is needed."""
    f = forcing_velocity_np(cfg)
    if f is None:
        return None
    f_hat = np.fft.rfftn(f, axes=(1, 2, 3))
    if cfg.dealias:
        f_hat = np.where(_dealias_mask_np(cfg)[None], f_hat, 0.0)
    f_hat[:, 0, 0, 0] = 0.0
    if cfg.compact:
        rows_x, rows_y, kzc = _compact_meta(cfg)
        f_hat = f_hat[:, rows_x][:, :, rows_y][:, :, :, :kzc]
    return f_hat


def _constants_key(cfg: Spectral3DConfig, device):
    """The cache key of cfg's constants on `device`: nt dropped (no
    constant depends on it) and the device as a tensor made there reports
    it, so "cuda" and cuda:0 share an entry and None stays the default
    device."""
    return (dataclasses.replace(cfg, nt=0),
            torch.empty(0, device=device).device)


def make_ops(cfg: Spectral3DConfig, device=None):
    """Spectral constants for the active layout on `device`: real
    wavenumber arrays, the dealias mask (fft engine) and the forcing
    spectrum as real/imaginary parts (keys as in the JAX package). A new
    dict over the cached tensors (`_constants_key`), which callers must not
    write into."""
    return dict(_ops_cached(*_constants_key(cfg, device)))


@device_table(maxsize=4)
def _ops_cached(cfg: Spectral3DConfig, device):
    with named_scope(CONSTANTS_SPAN):
        kx, ky, kz = _wavenumbers_np(cfg)
        k2 = kx * kx + ky * ky + kz * kz
        inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
        visc = np.exp(-cfg.nu * k2 * cfg.dt)
        as_t = lambda a: torch.as_tensor(a, dtype=cfg.real_dtype,
                                         device=device)
        ops = dict(kx=as_t(kx), ky=as_t(ky), kz=as_t(kz), k2=as_t(k2),
                   inv_k2=as_t(inv_k2), visc=as_t(visc))
        if not cfg.compact:
            mask = _dealias_mask_np(cfg) if cfg.dealias else np.ones(
                k2.shape[-3:], bool)
            ops["mask"] = torch.as_tensor(mask, device=device)
        f_hat = _forcing_hat_np(cfg)
        if f_hat is not None:
            ops["f_re"] = as_t(f_hat.real)
            ops["f_im"] = as_t(f_hat.imag)
        return ops


# ---------------------------------------------------------------------------
# Transforms: rfftn or per-axis DFT GEMMs (compact layout)
# ---------------------------------------------------------------------------

def _dft_constants_np(cfg: Spectral3DConfig):
    """Per-axis DFT matrices of the compact layout, host numpy complex128:

      forward:  z = Fx_t .x (Fy_t .y (w .z Fz_t^T))      (Rx, Ry, Kzc)
      inverse:  w = Re[(Fxi_t .x z) .y Fyi_t .z Bz]      (nx, ny, nz)

    with Bz the half-spectrum unfolding row basis (c_k/nz e^{+2pi i kj/nz},
    c_0 = 1, c_k = 2 — the truncation never keeps the Nyquist row)."""
    rows_x, rows_y, kzc = _compact_meta(cfg)

    def full(n):
        i = np.arange(n)
        return np.exp(-2j * np.pi * np.outer(i, i) / n)

    Fx = full(cfg.nx)
    Fy = full(cfg.ny)
    k = np.arange(kzc)
    j = np.arange(cfg.nz)
    Fz_t = np.exp(-2j * np.pi * np.outer(k, j) / cfg.nz)      # (kzc, nz)
    c = np.full(kzc, 2.0)
    c[0] = 1.0
    if kzc - 1 == cfg.nz // 2:  # unreached under 2/3 truncation; kept exact
        c[-1] = 1.0
    Bz = (c[:, None] / cfg.nz) * np.exp(
        2j * np.pi * np.outer(k, j) / cfg.nz)                 # (kzc, nz)
    return dict(
        Fx_t=Fx[rows_x, :],                                   # (Rx, nx)
        Fxi_t=(np.conj(Fx) / cfg.nx)[:, rows_x],              # (nx, Rx)
        Fy_t=Fy[rows_y, :],                                   # (Ry, ny)
        Fyi_t=(np.conj(Fy) / cfg.ny)[:, rows_y],              # (ny, Ry)
        Fz_t=Fz_t, Bz=Bz,
    )


def _dft_tables(cfg: Spectral3DConfig, device) -> dict:
    """The DFT constants as complex tensors on `device`: a new dict over
    the cached tensors, as `make_ops`."""
    return dict(_dft_tables_cached(*_constants_key(cfg, device)))


@device_table(maxsize=4)
def _dft_tables_cached(cfg: Spectral3DConfig, device) -> dict:
    with named_scope(CONSTANTS_SPAN):
        return {k: torch.as_tensor(v, dtype=cfg.complex_dtype, device=device)
                for k, v in _dft_constants_np(cfg).items()}


def _x_stage(M: torch.Tensor, t: torch.Tensor, precision) -> torch.Tensor:
    """Contract axis -3 of t (..., n, b, k) with M (m, n): (..., m, b, k)."""
    *lead, n, b, k = t.shape
    out = cmatmul(M, t.reshape(*lead, n, b * k), precision)
    return out.reshape(*lead, M.shape[0], b, k)


def make_compact_transforms(cfg: Spectral3DConfig, device=None):
    """(fwd, inv) between physical (..., nx, ny, nz) real fields and the
    compact spectrum (..., Rx, Ry, Kzc), batched over leading dims. The z
    and y stages are the twins of K6/K7 (or, with use_pallas_transform,
    the kernels themselves); the x-stage is a GEMM either way."""
    M = _dft_tables(cfg, device)
    prec = cfg.matmul_precision
    if cfg.use_pallas_transform:
        zy_fwd, yz_inv = t3k.fused_zy_forward, t3k.fused_yz_inverse
    else:
        zy_fwd, yz_inv = t3k.zy_forward, t3k.yz_inverse

    def fwd(w):
        t = zy_fwd(w.to(cfg.real_dtype).contiguous(), M["Fz_t"], M["Fy_t"],
                   precision=prec)
        return _x_stage(M["Fx_t"], t, prec)

    def inv(z):
        a = _x_stage(M["Fxi_t"], z, prec)
        return yz_inv(a.contiguous(), M["Fyi_t"], M["Bz"], cfg.nz,
                      precision=prec)

    return fwd, inv


def make_transforms(cfg: Spectral3DConfig, device=None):
    """(fwd, inv) for the active engine. fft: full rfftn layout. matmul:
    compact truncated layout (the caller's spectra are compact)."""
    if cfg.transform == "fft":
        s = (cfg.nx, cfg.ny, cfg.nz)
        return (lambda w: torch.fft.rfftn(w, dim=(-3, -2, -1)),
                lambda z: torch.fft.irfftn(z, s=s, dim=(-3, -2, -1)))
    return make_compact_transforms(cfg, device)


def expand_compact(cfg: Spectral3DConfig, z: torch.Tensor) -> torch.Tensor:
    """Compact (..., Rx, Ry, Kzc) -> full rfftn layout (..., nx, ny, nzh)."""
    rows_x, rows_y, kzc = _compact_meta(cfg)
    nzh = cfg.nz // 2 + 1
    out = torch.zeros(z.shape[:-3] + (cfg.nx, cfg.ny, nzh), dtype=z.dtype,
                      device=z.device)
    rx = torch.as_tensor(rows_x, device=z.device)[:, None]
    ry = torch.as_tensor(rows_y, device=z.device)[None, :]
    out[..., rx, ry, :kzc] = z
    return out


def gather_compact(cfg: Spectral3DConfig, z: torch.Tensor) -> torch.Tensor:
    """Full rfftn layout -> compact (kept modes; truncation drops the rest)."""
    rows_x, rows_y, kzc = _compact_meta(cfg)
    rx = torch.as_tensor(rows_x, device=z.device)[:, None]
    ry = torch.as_tensor(rows_y, device=z.device)[None, :]
    return z[..., rx, ry, :kzc]


# ---------------------------------------------------------------------------
# Physics: vorticity, Lamb vector, Leray projection, IF-AB2 step
# ---------------------------------------------------------------------------

def vorticity_from_velocity_hat(ops, u_hat: torch.Tensor) -> torch.Tensor:
    """omega_hat = i k x u_hat, stacked (3, ...)."""
    ux, uy, uz = u_hat[0], u_hat[1], u_hat[2]
    wx = _ik_mul(ops["ky"], uz) - _ik_mul(ops["kz"], uy)
    wy = _ik_mul(ops["kz"], ux) - _ik_mul(ops["kx"], uz)
    wz = _ik_mul(ops["kx"], uy) - _ik_mul(ops["ky"], ux)
    return torch.stack([wx, wy, wz])


def leray_project(ops, v_hat: torch.Tensor) -> torch.Tensor:
    """P(k) v = v - k (k . v) / k^2 — exact divergence removal. The k = 0
    mode passes through untouched (inv_k2[0] = 0)."""
    kdot = (ops["kx"] * v_hat[0] + ops["ky"] * v_hat[1]
            + ops["kz"] * v_hat[2])
    corr = kdot * ops["inv_k2"]
    return torch.stack([v_hat[0] - ops["kx"] * corr,
                        v_hat[1] - ops["ky"] * corr,
                        v_hat[2] - ops["kz"] * corr])


@device_table(maxsize=4)
def _fused_lamb_op(cfg: Spectral3DConfig, device: torch.device):
    """The nonlinear term's physical leg under the fused route: x-inverse
    GEMM -> K8 (yz-inverse of (u, omega), u x omega, zy-forward; no
    physical field in device memory) -> x-forward GEMM. One closure per
    (config, device), holding the cached DFT tables on that device."""
    M = _dft_tables(cfg, device)
    prec = cfg.matmul_precision

    def lamb_hat(z6):
        a6 = _x_stage(M["Fxi_t"], z6, prec).contiguous()
        out = t3k.fused_lamb(a6, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"],
                             cfg.nz, precision=prec)
        return _x_stage(M["Fx_t"], out, prec)

    return lamb_hat


def nonlinear_term(cfg: Spectral3DConfig, ops, transforms,
                   u_hat: torch.Tensor) -> torch.Tensor:
    """N_hat = P[FFT(u x omega)] (+ f_hat), dealiased, with the mean mode
    pinned to zero (<u x omega> = 0 in a periodic box)."""
    with named_scope(NONLINEAR_SPAN):
        fwd, inv = transforms
        w_hat = vorticity_from_velocity_hat(ops, u_hat)
        if cfg.use_pallas_transform:
            # the whole physical leg in one fused call (K8)
            N = _fused_lamb_op(cfg, u_hat.device)(torch.cat([u_hat, w_hat]))
        else:
            N = fwd(t3k.cross(inv(torch.cat([u_hat, w_hat]))))
        if not cfg.compact and cfg.dealias:
            N = torch.where(ops["mask"], N, 0.0)
        N = leray_project(ops, N)
        N[:, 0, 0, 0] = 0.0
        if "f_re" in ops:  # constant body forcing rides the projected RHS
            N = N + torch.complex(ops["f_re"], ops["f_im"])
        return N


def make_step(cfg: Spectral3DConfig, device=None):
    """One IF-AB2 step on (u_hat, N_prev_hat):

      u^{n+1} = E u^n + dt (3/2 E N^n - 1/2 E^2 N^{n-1}),  E = e^{-nu k^2 dt}

    Returns (step, ops); step(carry) -> (new_carry, u_new)."""
    ops = make_ops(cfg, device)
    transforms = make_transforms(cfg, device)
    E = ops["visc"]

    def step(carry):
        u_hat, N_prev = carry
        N = nonlinear_term(cfg, ops, transforms, u_hat)
        u_new = E * u_hat + cfg.dt * (1.5 * E * N - 0.5 * (E * E) * N_prev)
        return (u_new, N), u_new

    return step, ops


# ---------------------------------------------------------------------------
# Init / rollouts
# ---------------------------------------------------------------------------

def _as_velocity(cfg: Spectral3DConfig, u0, device=None) -> torch.Tensor:
    """u0 as a real tensor on `device`. With device None a tensor stays on
    its own device and host data goes to CUDA (core/device.py)."""
    if isinstance(u0, torch.Tensor):
        return u0.to(device=device or u0.device, dtype=cfg.real_dtype)
    return torch.as_tensor(np.asarray(u0), dtype=cfg.real_dtype,
                           device=resolve_device(device))


def _carry_builder(cfg: Spectral3DConfig, device):
    """u0 -> carry on `device`, its constants built once: transform,
    dealias, Leray-project the IC (guards imperfectly solenoidal inputs),
    self-start the AB2 history with the first nonlinear eval."""
    ops = make_ops(cfg, device)
    transforms = make_transforms(cfg, device)

    def build(u0):
        u_hat = transforms[0](u0.to(cfg.real_dtype))
        if not cfg.compact and cfg.dealias:
            u_hat = torch.where(ops["mask"], u_hat, 0.0)
        u_hat = leray_project(ops, u_hat)
        return u_hat, nonlinear_term(cfg, ops, transforms, u_hat)

    return build


def carry_from_velocity(cfg: Spectral3DConfig, u0: torch.Tensor):
    """Carry from a physical (3, nx, ny, nz) velocity on its device
    (`_carry_builder`)."""
    return _carry_builder(cfg, u0.device)(u0)


def init_from_velocity(cfg: Spectral3DConfig, u0, device=None):
    """Carry from a velocity given as numpy or torch, on `device` (default:
    the tensor's own, or CUDA for numpy; core/device.py)."""
    return carry_from_velocity(cfg, _as_velocity(cfg, u0, device))


def _advance(step, carry, n: int):
    """`n` steps from `carry`; the final carry."""
    for _ in range(n):
        carry, _ = step(carry)
    return carry


def rollout_final(cfg: Spectral3DConfig, carry0):
    """Rollout of cfg.nt steps returning only the final carry."""
    step, _ = make_step(cfg, carry0[0].device)
    return _advance(step, carry0, cfg.nt)


def simulate_hat(cfg: Spectral3DConfig, carry0) -> torch.Tensor:
    """Rollout returning the stacked velocity spectra (nt, 3, ...)."""
    step, _ = make_step(cfg, carry0[0].device)
    out = torch.empty((cfg.nt, *carry0[0].shape), dtype=carry0[0].dtype,
                      device=carry0[0].device)
    carry = carry0
    for n in range(cfg.nt):
        carry, out[n] = step(carry)
    return out


def _extract_cfg(cfg: Spectral3DConfig) -> Spectral3DConfig:
    """Extraction/diagnostic twin: same engine and layout, fused stages OFF
    (the JAX package's rule: the fused kernels serve the step loop;
    extraction runs the plain chain)."""
    if not cfg.use_pallas_transform:
        return cfg
    return dataclasses.replace(cfg, use_pallas_transform=False)


def fields_from_hat(cfg: Spectral3DConfig, u_hat: torch.Tensor):
    """Physical (3, nx, ny, nz) velocity from a spectrum in the active
    layout (always the plain chain; see _extract_cfg)."""
    _, inv = make_transforms(_extract_cfg(cfg), u_hat.device)
    return inv(u_hat)


def _pressure(cfg: Spectral3DConfig, ops, fwd, inv, u: torch.Tensor):
    """p from the physical velocity u (3, nx, ny, nz)."""
    prods = torch.stack([u[0] * u[0], u[1] * u[1], u[2] * u[2],
                         u[0] * u[1], u[0] * u[2], u[1] * u[2]])
    T = fwd(prods)
    kk = (ops["kx"] ** 2 * T[0] + ops["ky"] ** 2 * T[1]
          + ops["kz"] ** 2 * T[2]
          + 2.0 * (ops["kx"] * ops["ky"] * T[3]
                   + ops["kx"] * ops["kz"] * T[4]
                   + ops["ky"] * ops["kz"] * T[5]))
    p_hat = -cfg.rho * kk * ops["inv_k2"]
    return inv(p_hat[None])[0]


def pressure_from_hat(cfg: Spectral3DConfig, u_hat: torch.Tensor):
    """Diagnostic pressure: p_hat = -rho k_i k_j T_ij_hat / k^2 with
    T = u u, by the plain chain (_extract_cfg)."""
    ops = make_ops(cfg, u_hat.device)
    fwd, inv = make_transforms(_extract_cfg(cfg), u_hat.device)
    return _pressure(cfg, ops, fwd, inv, inv(u_hat))


def make_extractor(cfg: Spectral3DConfig, device=None):
    """u_hat -> (u, v, w, p) on `device`: fields_from_hat and
    pressure_from_hat with their constants built once (the per-frame
    extraction of the rollouts), sharing the velocity's inverse."""
    ops = make_ops(cfg, device)
    fwd, inv = make_transforms(_extract_cfg(cfg), device)

    def extract(u_hat):
        u = inv(u_hat)
        return u[0], u[1], u[2], _pressure(cfg, ops, fwd, inv, u)

    return extract


def simulate_strided(cfg: Spectral3DConfig, u0, n_frames: int,
                     stride: int = 1, spinup: int = 0, device=None):
    """Strided rollout from a physical (3, nx, ny, nz) velocity: (u, v, w,
    p) stacked (n_frames, nx, ny, nz), materializing only the saved
    frames. Frame i is the state after 1 + spinup + i*stride steps. The
    rollout runs on `device` (default: u0's own, or CUDA for numpy)."""
    u0 = _as_velocity(cfg, u0, device)
    step, _ = make_step(cfg, u0.device)
    extract = make_extractor(cfg, u0.device)
    frames = torch.empty((4, n_frames, cfg.nx, cfg.ny, cfg.nz),
                         dtype=cfg.real_dtype, device=u0.device)

    def emit(i, c):
        for j, f in enumerate(extract(c[0])):
            frames[j, i] = f

    carry = _advance(step, carry_from_velocity(cfg, u0), 1 + spinup)
    emit(0, carry)
    for i in range(1, n_frames):
        carry = _advance(step, carry, stride)
        emit(i, carry)
    return tuple(frames)


# ---------------------------------------------------------------------------
# Initial conditions (host-side numpy: seeded, reproducible, bitwise equal
# to the JAX package's for the same seed)
# ---------------------------------------------------------------------------

def taylor_green_velocity(cfg: Spectral3DConfig, k: int = 1) -> np.ndarray:
    """The canonical 3D Taylor-Green vortex (Brachet et al. 1983):
    u = sin(kx)cos(ky)cos(kz), v = -cos(kx)sin(ky)cos(kz), w = 0."""
    x = 2.0 * np.pi * np.arange(cfg.nx) / cfg.nx
    y = 2.0 * np.pi * np.arange(cfg.ny) / cfg.ny
    z = 2.0 * np.pi * np.arange(cfg.nz) / cfg.nz
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    u = np.stack([np.sin(k * X) * np.cos(k * Y) * np.cos(k * Z),
                  -np.cos(k * X) * np.sin(k * Y) * np.cos(k * Z),
                  np.zeros_like(X)])
    return u.astype(_np_dtype(cfg))


def random_solenoidal_velocity(cfg: Spectral3DConfig, seed: int = 0,
                               k_peak: float = 4.0) -> np.ndarray:
    """Random isotropic solenoidal velocity with energy peaked near k_peak:
    u = curl(A) of a random vector potential with a k^2 exp(-(k/kp)^2)
    amplitude spectrum — divergence-free exactly. Normalized to unit max
    speed."""
    rng = np.random.default_rng(seed)
    kx = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)[:, None, None]
    ky = np.fft.fftfreq(cfg.ny, d=1.0 / cfg.ny)[None, :, None]
    kz = np.fft.rfftfreq(cfg.nz, d=1.0 / cfg.nz)[None, None, :]
    kmag = np.sqrt(kx**2 + ky**2 + kz**2)
    amp = kmag**2 * np.exp(-0.5 * (kmag / k_peak) ** 2)
    shape = amp.shape
    A_hat = amp * np.exp(1j * rng.uniform(0, 2 * np.pi, (3,) + shape))
    u_hat = np.stack([1j * (ky * A_hat[2] - kz * A_hat[1]),
                      1j * (kz * A_hat[0] - kx * A_hat[2]),
                      1j * (kx * A_hat[1] - ky * A_hat[0])])
    u = np.fft.irfftn(u_hat, s=(cfg.nx, cfg.ny, cfg.nz), axes=(1, 2, 3))
    u = u / np.abs(u).max()
    return u.astype(_np_dtype(cfg))


def kolmogorov_fixed_point_velocity(cfg: Spectral3DConfig) -> np.ndarray:
    """The laminar Kolmogorov-flow fixed point u = amp/(nu k^2) sin(ky) x_hat
    of the forced equations (forcing='kolmogorov') — validation IC."""
    if cfg.forcing != "kolmogorov":
        raise ValueError("fixed point is defined for forcing='kolmogorov'")
    y = 2.0 * np.pi * np.arange(cfg.ny) / cfg.ny
    k = cfg.forcing_k
    u = np.zeros((3, cfg.nx, cfg.ny, cfg.nz))
    u[0] = (cfg.forcing_amp / (cfg.nu * k * k)
            * np.sin(k * y))[None, :, None]
    return u.astype(_np_dtype(cfg))


def _np_dtype(cfg: Spectral3DConfig):
    return np.float64 if cfg.dtype == "float64" else np.float32


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def _hermitian_weights(cfg: Spectral3DConfig, device) -> torch.Tensor:
    """Conjugate-pair weights of the rfft z-half-spectrum in the active
    layout: interior kz modes represent two full-spectrum modes. The cached
    tensor (`_constants_key`)."""
    return _hermitian_weights_cached(*_constants_key(cfg, device))


@device_table(maxsize=4)
def _hermitian_weights_cached(cfg: Spectral3DConfig, device) -> torch.Tensor:
    with named_scope(CONSTANTS_SPAN):
        nzh = cfg.nz // 2 + 1
        w = np.full(nzh, 2.0)
        w[0] = 1.0
        if cfg.nz % 2 == 0:
            w[-1] = 1.0
        if cfg.compact:
            w = w[:_compact_meta(cfg)[2]]
        return torch.as_tensor(w[None, None, :], dtype=cfg.real_dtype,
                               device=device)


_CONSTANT_CACHES = {"make_ops": _ops_cached,
                    "dft_tables": _dft_tables_cached,
                    "hermitian_weights": _hermitian_weights_cached}


def constants_cache_info() -> dict:
    """Each cached constant builder's `cache_info()` (hits, misses,
    maxsize, currsize), by the name of the function that reads it."""
    return {name: f.cache_info() for name, f in _CONSTANT_CACHES.items()}


def _norm(cfg: Spectral3DConfig) -> float:
    return float(cfg.nx * cfg.ny * cfg.nz) ** 2


def energy(cfg: Spectral3DConfig, u_hat: torch.Tensor) -> torch.Tensor:
    """Total kinetic energy (1/2) <|u|^2> from the spectrum (Parseval)."""
    w = _hermitian_weights(cfg, u_hat.device)
    return 0.5 * torch.sum((u_hat.real**2 + u_hat.imag**2) * w) / _norm(cfg)


def enstrophy(cfg: Spectral3DConfig, u_hat: torch.Tensor) -> torch.Tensor:
    """(1/2) <|omega|^2>; the dissipation rate is eps = 2 nu Z."""
    ops = make_ops(cfg, u_hat.device)
    w_hat = vorticity_from_velocity_hat(ops, u_hat)
    w = _hermitian_weights(cfg, u_hat.device)
    return 0.5 * torch.sum((w_hat.real**2 + w_hat.imag**2) * w) / _norm(cfg)


def divergence_max(cfg: Spectral3DConfig, u_hat: torch.Tensor):
    """Max |div u| in physical space — ~0 by construction (Leray form).
    Under the fused route the inverse runs through K7."""
    ops = make_ops(cfg, u_hat.device)
    _, inv = make_transforms(cfg, u_hat.device)
    div_hat = (_ik_mul(ops["kx"], u_hat[0]) + _ik_mul(ops["ky"], u_hat[1])
               + _ik_mul(ops["kz"], u_hat[2]))
    return torch.max(torch.abs(inv(div_hat[None])[0]))


def energy_spectrum(cfg: Spectral3DConfig, u_hat: torch.Tensor):
    """Shell-binned isotropic kinetic-energy spectrum E(k)."""
    ops = make_ops(cfg, u_hat.device)
    w = _hermitian_weights(cfg, u_hat.device)
    e_density = 0.5 * torch.sum(
        (u_hat.real**2 + u_hat.imag**2), dim=0) * w / _norm(cfg)
    k_mag = torch.sqrt(ops["kx"]**2 + ops["ky"]**2 + ops["kz"]**2)
    nbins = min(cfg.nx, cfg.ny, cfg.nz) // 2 + 1
    k_idx = torch.clamp(torch.round(k_mag).to(torch.int64), 0, nbins - 1)
    k_idx = k_idx.expand(e_density.shape)
    spec = torch.zeros(nbins, dtype=cfg.real_dtype, device=u_hat.device)
    spec.index_add_(0, k_idx.reshape(-1), e_density.reshape(-1))
    return torch.arange(nbins, device=u_hat.device), spec


# ---------------------------------------------------------------------------
# Family-standard API wrapper
# ---------------------------------------------------------------------------

class NavierStokesSystem3D:
    """API wrapper matching the other families: simulate() -> (u, v, w, p)
    stacked (nt, nx, ny, nz) rollouts on `device` (default CUDA, whatever
    u_ic is; core/device.py). For long horizons use
    simulate_strided (saved frames only). The step and the extraction
    constants are built once, as the JAX wrapper compiles its programs
    once."""

    def __init__(self, u_ic, nt=100, nx=64, ny=64, nz=64, dt=1e-3,
                 nu=6.25e-4, rho=1.0, dealias=True, dtype="float32",
                 transform="fft", matmul_precision="high",
                 forcing="none", forcing_k=4, forcing_amp=0.1,
                 use_pallas_transform=False, device=None):
        self.cfg = Spectral3DConfig(
            nt=nt, nx=nx, ny=ny, nz=nz, dt=dt, nu=nu, rho=rho,
            dealias=dealias, dtype=dtype, transform=transform,
            matmul_precision=matmul_precision, forcing=forcing,
            forcing_k=forcing_k, forcing_amp=forcing_amp,
            use_pallas_transform=use_pallas_transform)
        self._u_ic = _as_velocity(self.cfg, u_ic, resolve_device(device))
        self.carry0 = carry_from_velocity(self.cfg, self._u_ic)
        self._step, _ = make_step(self.cfg, self._u_ic.device)
        self._extract = make_extractor(self.cfg, self._u_ic.device)

    def simulate(self):
        """Every step's (u, v, w, p), each (nt, nx, ny, nz); the fields of
        a frame are extracted right after its step."""
        cfg = self.cfg
        out = torch.empty((4, cfg.nt, cfg.nx, cfg.ny, cfg.nz),
                          dtype=cfg.real_dtype, device=self._u_ic.device)
        carry = self.carry0
        for n in range(cfg.nt):
            carry, u_hat = self._step(carry)
            for j, f in enumerate(self._extract(u_hat)):
                out[j, n] = f
        return tuple(out)

    def simulate_strided(self, n_frames, stride=1, spinup=0, u_ic=None):
        u = self._u_ic if u_ic is None else _as_velocity(
            self.cfg, u_ic, self._u_ic.device)
        return simulate_strided(self.cfg, u, n_frames, stride=stride,
                                spinup=spinup)

    def final_state(self):
        """The carry after cfg.nt steps from carry0 (rollout_final)."""
        return _advance(self._step, self.carry0, self.cfg.nt)


# ---------------------------------------------------------------------------
# The carry across packages
# ---------------------------------------------------------------------------

def carry_to_numpy(carry) -> tuple[np.ndarray, np.ndarray]:
    """A carry (u_hat, N_prev) from either package as complex numpy arrays."""
    conv = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))
    return conv(carry[0]), conv(carry[1])


def carry_from_numpy(cfg: Spectral3DConfig, carry, device=None):
    """Inverse of `carry_to_numpy`: complex numpy arrays onto `device` in
    the config's complex dtype (CUDA for None, core/device.py)."""
    device = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a), dtype=cfg.complex_dtype,
                              device=device) for a in carry)
