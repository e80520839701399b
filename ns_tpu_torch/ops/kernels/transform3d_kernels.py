"""Fused 3D transform kernels: wrappers of K6, K7, K8
(`csrc/transform3d_kernels.cu`).

Each wrapper replaces a kernel of `ns_tpu/ops/pallas/transform3d_kernels.py`
with its signature less `interpret`/`block_x`, and keeps a plain twin that
computes what the Pallas kernel body computes:
  K6 `fused_zy_forward` <- `fused_zy_forward` (`_fwd_kernel`);
                           twin `zy_forward`
  K7 `fused_yz_inverse` <- `fused_yz_inverse` (`_inv_kernel`);
                           twin `yz_inverse`
  K8 `fused_lamb`       <- `fused_lamb` (`_lamb_kernel`); twin `lamb`

The twins are also the z and y stages of the plain compact transform
(`solvers/spectral3d.py::make_compact_transforms`), at the configured
`precision` (`ops/gemm.py`). The kernels are float32 (as on the TPU, where
Mosaic had no float64). All three follow the JAX kernels' precision
contract (`_prec`): at 'default' each launches its tensor-core kernel,
with the TPU DEFAULT's rounding points (every GEMM operand rounded to
bf16, fp32 accumulation and result; K6: w, Fz_t, t and Fy_t; K7: a,
Fyi_t, t and Bz; K8: K7's on the six fields, then K6's on the three
products), which are also the twins' at 'default'; at 'high' and
'highest' (both HIGHEST on the TPU) an fp32-class kernel on the TF32
tensor cores with every product split in three (3xTF32: `tf32_split`;
fp32 accumulation).

The DFT tables (`Fz_t`, `Fy_t`, `Fyi_t`, `Bz`) may be host numpy arrays, as
the JAX wrappers take them, or complex torch tensors; the solver passes
tensors already on the device. Each wrapper turns them into complex
tensors on the input's device and calls its operator in `torch.ops.ns_tpu`
(`library.py`), the precision as a string: on a CPU tensor it runs the
twin, on a CUDA tensor it launches the kernel or raises. Each wrapper
counts its calls that launched in `launches` (K8 is two CUDA launches per
call and counts one), its bf16 tensor-core calls also in `launches_bf16`,
and its 3xTF32 calls in `launches_tf32`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ns_tpu_torch.ops.gemm import cmatmul
from ns_tpu_torch.ops.kernels import _build
from ns_tpu_torch.ops.kernels.poisson_kernels import SMEM_BUDGET

# tile sizes of csrc/transform3d_kernels.cu: K6's tensor-core kernel
# (kBTY, kBKC): y-rows per tile, output columns per block
BF16_TY = 32
BF16_KC = 48
# K7's and K8's tensor-core kernels (kVTY): y-rows per block
INV_TY = 32
# K6's 3xTF32 kernel (kTTY, kTKZ, kTStages): y-rows per tile, z per
# slice, slices in flight; its shared memory (the stages of a w slice and
# an Fz slice, and t's big and small planes) does not depend on the grid
TF32_TY = 64
TF32_KZ = 32
TF32_STAGES = 4
TF32_SMEM = (TF32_STAGES * (TF32_KZ // 8) * (2 * BF16_KC // 8) * 32 * 16
             + 4 * (TF32_STAGES * TF32_TY * (TF32_KZ + 8)
                    + 2 * 2 * BF16_KC * (TF32_TY + 8)))
# K7's 3xTF32 kernel (kUTY, kUNTs): y-rows per block; its instances by
# Kzc n-tiles (a Kzc takes the first that holds it)
TF32_INV_TY = 128
TF32_INV_NTS = (3, 6, 11, 13)
# K8's 3xTF32 pair (kLTY, kLStages): y-rows per block of its first launch,
# y-inverse k-steps in flight; its second launch (K6's y-stage) holds two
# tiles of S's big and small planes
LAMB_TY = 16
LAMB_STAGES = 4
LAMB_YFWD_SMEM = 2 * 2 * (2 * BF16_KC) * (TF32_TY + 8) * 4


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _inv_nt(kzc: int) -> int:
    """The Kzc n-tiles of K7's 3xTF32 instance for kzc: the first of
    TF32_INV_NTS that holds it, else (no instance) ceil(kzc / 8)."""
    return next((n for n in TF32_INV_NTS if 8 * n >= kzc), -(-kzc // 8))


def smem_bytes(nx: int, ny: int, nz: int, ry: int, kzc: int,
               precision: str = "high") -> dict:
    """Shared memory (bytes) each kernel's block needs at this grid and
    precision, as the CUDA entries request it (at 'default' the bf16
    tensor-core kernels, else the 3xTF32 kernels; K8's the larger of its
    two launches). K7's and K8's 3xTF32 kernels take the first of their
    instances (TF32_INV_NTS) that holds Kzc's n-tiles; past 13 n-tiles
    K7's t planes would not fit, and neither has one."""
    c, f, h = 8, 4, 2  # complex64, float32, bf16
    if precision == "default":
        nzs = _up(nz, 16) + 8  # the w and Fz tiles' row stride
        tile = BF16_TY * (2 * BF16_KC + 8) * h  # one t tile of K6's y-stage
        ks = 2 * _up(kzc, 16) + 8  # the row stride of K7's, K8's tiles
        a_s = _up(ry, 16) * ks * h  # one slab's spectrum
        l_s = 3 * INV_TY * nzs * h  # K8's three products
        return {
            "fused_zy_forward": (2 * BF16_TY * nzs * f
                                 + 2 * BF16_KC * nzs * h + tile),
            "fused_yz_inverse": a_s + INV_TY * ks * h,
            "fused_lamb": max(max(a_s, l_s) + 6 * INV_TY * ks * h,
                              2 * tile),
        }
    # K7: its instance's Kzc n-tiles, the slab's spectrum, then t's planes
    # over it
    nt = _inv_nt(kzc)
    sa, st = _up(8 * nt, 16) + 2, 16 * nt + 8  # spectrum and t row strides
    inv = max(_up(ry, 8) * sa * c, 2 * TF32_INV_TY * st * f)
    # K8's first launch: its ring of k-steps (Fyi's fragments, 8 spectrum
    # rows of six fields), then, over it, t of six fields and the three
    # products' big and small planes (row stride nz rounded up to 32, + 8)
    ring = LAMB_STAGES * (4 * 32 * 16 + 6 * 8 * sa * c)
    body = 6 * LAMB_TY * (st + _up(nz, 32) + 8) * f
    return {
        "fused_zy_forward": TF32_SMEM,
        "fused_yz_inverse": inv,
        "fused_lamb": max(ring, body, LAMB_YFWD_SMEM),
    }


def fused_fits(nx: int, ny: int, nz: int, ry: int, kzc: int,
               precision: str = "high") -> bool:
    """Whether every fused kernel's block fits one Hopper block's shared
    memory at this grid and precision (the counterpart of the TPU's
    `lamb_block_x` VMEM check). At 'high'/'highest' K7's 3xTF32 kernel
    binds: it holds one slab's spectrum in fp32, then t's big and small
    planes of its 128-row y-tile over it (188,416 bytes at 256^3; 352^3
    does not fit), and K8's 3xTF32 pair, which streams the spectrum,
    needs less wherever K7's fits (172,032 bytes at 256^3); at 'default'
    K8's tensor-core kernel binds: it holds one slab's spectrum and the
    six fields' y-inverse of its y-tile in bf16 (147,200 bytes at 256^3;
    352^3 fits, 384^3 does not)."""
    return (max(smem_bytes(nx, ny, nz, ry, kzc, precision).values())
            <= SMEM_BUDGET)


def _table(m, like: torch.Tensor) -> torch.Tensor:
    """A DFT table as a complex tensor on `like`'s device, in the complex
    type matching `like`."""
    cdt = (torch.complex128 if like.dtype in (torch.float64, torch.complex128)
           else torch.complex64)
    return torch.as_tensor(m, dtype=cdt, device=like.device)


# --- plain twins ------------------------------------------------------------

def zy_forward(w: torch.Tensor, Fz_t, Fy_t, precision: str = "high"):
    """(..., nx, ny, nz) real -> (..., nx, Ry, Kzc) complex:
    t = w @ Fz_t^T (z-stage), then Fy_t @ t (y-stage)."""
    t = cmatmul(w, _table(Fz_t, w).transpose(0, 1), precision)
    return cmatmul(_table(Fy_t, w), t, precision)


def yz_inverse(a: torch.Tensor, Fyi_t, Bz, nz: int, precision: str = "high"):
    """(..., nx, Ry, Kzc) complex -> (..., nx, ny, nz) real:
    t = Fyi_t @ a (y-inverse), then Re(t) Bz_re - Im(t) Bz_im (z-unfold)."""
    t = cmatmul(_table(Fyi_t, a), a, precision)
    bz = _table(Bz, a)
    return (cmatmul(t.real, bz.real, precision)
            - cmatmul(t.imag, bz.imag, precision))


def cross(f: torch.Tensor) -> torch.Tensor:
    """u x omega for f = (u1, u2, u3, w1, w2, w3) stacked on axis 0."""
    u1, u2, u3, w1, w2, w3 = f
    return torch.stack([u2 * w3 - u3 * w2, u3 * w1 - u1 * w3,
                        u1 * w2 - u2 * w1])


def lamb(a6: torch.Tensor, Fyi_t, Bz, Fz_t, Fy_t, nz: int,
         precision: str = "default"):
    """(6, nx, Ry, Kzc) (u, omega) after the x-inverse -> (3, nx, Ry, Kzc)
    Lamb vector u x omega before the x-forward."""
    return zy_forward(cross(yz_inverse(a6, Fyi_t, Bz, nz, precision)), Fz_t,
                      Fy_t, precision)


# --- wrappers -----------------------------------------------------------------

def _check_fit(what: str, dims: dict, precision: str = "high") -> None:
    need = smem_bytes(**dims, precision=precision)[what]
    if need > SMEM_BUDGET:
        raise ValueError(f"{what}: a grid of {dims} needs {need} bytes "
                         f"of shared memory per block, over the "
                         f"{SMEM_BUDGET} a Hopper block can have")


def _real_view(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t.contiguous())


@functools.cache
def _frag_index(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, col) in a 16x16 A tile of the 8 bf16 that each lane of a warp
    holds in mma.m16n8k16's A fragment, in register order: (g, 2t + e),
    (g + 8, 2t + e), (g, 2t + 8 + e), (g + 8, 2t + 8 + e) for e = 0, 1,
    with g = lane // 4 and t = lane % 4. Both (32, 8), made once per
    device (a host-to-card copy per call would wait for the stream)."""
    lane = torch.arange(32, device=device)[:, None]
    e = torch.arange(8, device=device)[None, :]
    reg, lo = e // 2, e % 2
    row = lane // 4 + 8 * (reg % 2)
    col = 2 * (lane % 4) + lo + 8 * (reg // 2)
    return row, col


def bf16_tables(fz: torch.Tensor, fy: torch.Tensor):
    """K6's tensor-core operands from the complex64 tables Fz_t (Kzc, nz)
    and Fy_t (Ry, ny), rounded to bf16 on their device (the layouts of
    csrc/transform3d_kernels.cu::zy_forward_bf16_kernel):

      fzb (nchunks, 2 BF16_KC, nzp): chunk c's rows n < BF16_KC are
          Re Fz_t[c BF16_KC + n], the next BF16_KC rows Im, zero-padded
          past Kzc and nz (nzp = nz rounded up to 16);
      afrag (nyt, rt, 2, 2, 32, 8): Fy_t's real and imaginary parts
          (zero-padded to rt = ceil(Ry / 16) row tiles and to whole
          y-tiles) cut into 16x16 A tiles in mma fragment order: entry
          (j, r, h, q, lane) is lane's fragment of the tile of Fy_re
          (q = 0) or Fy_im (q = 1) at rows 16 r .., columns
          y = j BF16_TY + 16 h ... The kernel builds the y-stage's block
          matrix [[Fy_re, -Fy_im], [Fy_im, Fy_re]] from them.
    """
    kzc, nz = fz.shape
    ry, ny = fy.shape
    nyt = -(-ny // BF16_TY)
    kcp = _up(kzc, BF16_KC)
    # (re, im) planes of Fz_t, by chunk
    fzb = _parts(fz, kcp, _up(nz, 16)).unflatten(1, (-1, BF16_KC))
    # Fy_t's fragments (q, s = 2 j + h, r, ...) -> (j, r, h, q, ...)
    f = _frag_order(_parts(fy, _up(ry, 16), nyt * BF16_TY))
    f = f.unflatten(1, (nyt, 2)).permute(1, 3, 2, 0, 4, 5)
    bf16 = dict(dtype=torch.bfloat16, memory_format=torch.contiguous_format)
    return (fzb.transpose(0, 1).reshape(-1, 2 * BF16_KC, fzb.shape[-1])
            .to(**bf16), f.to(**bf16))


def _frag_order(x: torch.Tensor) -> torch.Tensor:
    """x (..., R, C), R and C multiples of 16, cut into 16x16 tiles in mma
    A fragment order: (..., C/16, R/16, 32, 8), entry (s, r, lane) the 8
    values of lane's fragment of the tile at rows 16 r .., columns 16 s ...
    Read as B fragments of x^T (k = x's columns, n = its rows), a lane's
    registers (0, 2) are n-tile 0's and (1, 3) n-tile 1's."""
    *lead, R, C = x.shape
    t = x.reshape(*lead, R // 16, 16, C // 16, 16).movedim(-2, -4)
    row, col = _frag_index(x.device)
    return t[..., row, col]


def _parts(m: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(2, rows, cols) float: the re and im parts of complex m, zero-padded
    at the end of both axes."""
    r, c = m.shape
    return F.pad(torch.view_as_real(m).permute(2, 0, 1),
                 (0, cols - c, 0, rows - r))


def inverse_tables(fyi: torch.Tensor, bz: torch.Tensor):
    """K7's and K8's y-inverse and z-unfold operands from the complex64
    tables Fyi_t (ny, Ry) and Bz (Kzc, nz), rounded to bf16 on their device
    (the layouts of csrc/transform3d_kernels.cu::y_inverse_bf16 and
    ::z_unfold_bf16; kp, ryp, nzp: Kzc, Ry, nz rounded up to 16; nyp: ny
    rounded up to INV_TY):

      afi (ryp/16, nyp/16, 2, 32, 8): Fyi_t's real (q = 0) and imaginary
          (q = 1) parts in mma A fragment order, entry (s, m, q, lane) the
          tile at rows y = 16 m .., columns 16 s ..;
      bzf (nzp/16, 2 kp/16, 32, 8): [Bz_re; -Bz_im] (2 kp, nzp) as B
          fragments, entry (zp, k, lane) the 16 z columns from 16 zp and
          the 16 rows from 16 k (`_frag_order` of its transpose).
    """
    ny, ry = fyi.shape
    kzc, nz = bz.shape
    kp, nzp = _up(kzc, 16), _up(nz, 16)
    afi = _frag_order(_parts(fyi, _up(ny, INV_TY), _up(ry, 16))
                      ).permute(1, 2, 0, 3, 4)
    re, im = _parts(bz, kp, nzp)
    bzf = _frag_order(torch.cat([re, -im]).T).transpose(0, 1)
    bf16 = dict(dtype=torch.bfloat16, memory_format=torch.contiguous_format)
    return afi.to(**bf16), bzf.to(**bf16)


def lamb_tables(fyi: torch.Tensor, bz: torch.Tensor, fz: torch.Tensor,
                fy: torch.Tensor):
    """K8's operands at 'default': `inverse_tables`, then

      fzf (2 kp/16, nzp/16, 32, 8): [Re Fz_t; Im Fz_t] (2 kp, nzp) as the
          z-forward's B fragments, entry (p, zs, lane) the 16 t1 columns
          from 16 p and the 16 z rows from 16 zs (`_frag_order`);
      afrag: K6's y-stage fragments of Fy_t (`bf16_tables`).
    """
    afi, bzf = inverse_tables(fyi, bz)
    kzc, nz = fz.shape
    re, im = _parts(fz, _up(kzc, 16), _up(nz, 16))
    fzf = _frag_order(torch.cat([re, im])).transpose(0, 1).to(
        dtype=torch.bfloat16, memory_format=torch.contiguous_format)
    return afi, bzf, fzf, bf16_tables(fz, fy)[1]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to tf32 as `cvt.rna.tf32.f32` rounds it: to
    nearest at 10 mantissa bits (13 dropped), ties away from zero; float32
    with the low 13 bits zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x as tf32 (big, small): big = tf32(x), small = tf32(x -
    big) (x - big is exact in float32). big + small is within one
    float32 ulp of x: the 3xTF32 products keep fp32's accuracy."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _lane_gt(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    lane = torch.arange(32, device=device)
    return lane // 4, lane % 4


def _tf32_a_frags(x: torch.Tensor) -> torch.Tensor:
    """x (..., R, C) float32, R a multiple of 16 and C of 8, cut into
    16x8 A tiles of mma.m16n8k8 in the 3xTF32 kernels' fragment order:
    (..., C/8, R/16, 32, 4), entry (s, r, lane, i) = x[16 r + g + 8 (i %
    2), 8 s + 2 tq + i // 2] (g = lane // 4, tq = lane % 4): the lane's
    registers a0..a3, its k = tq taken from column 2 tq of the step and
    k = tq + 4 from 2 tq + 1."""
    *lead, R, C = x.shape
    t = x.reshape(*lead, R // 16, 16, C // 8, 8).movedim(-2, -4)
    g, tq = _lane_gt(x.device)
    i = torch.arange(4, device=x.device)
    return t[..., g[:, None] + 8 * (i % 2), 2 * tq[:, None] + i // 2]


def _tf32_b_frags(x: torch.Tensor) -> torch.Tensor:
    """x (..., K, N) float32, K and N multiples of 8, cut into 8x8 B tiles
    of mma.m16n8k8, split: (..., K/8, N/8, 32, 4), entry (s, n, lane) =
    (b0 big, b1 big, b0 small, b1 small) with b_i = x[8 s + 2 tq + i, 8 n +
    g] (the A side's permutation of k)."""
    *lead, K, N = x.shape
    t = x.reshape(*lead, K // 8, 8, N // 8, 8).movedim(-2, -3)
    g, tq = _lane_gt(x.device)
    i = torch.arange(2, device=x.device)
    big, small = tf32_split(t[..., 2 * tq[:, None] + i, g[:, None]])
    return torch.cat([big, small], -1)


def _tf32_a_planes(m: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The complex table m zero-padded to (rows, cols) as A fragments
    (`_tf32_a_frags`), its planes stacked on axis 2: (cols/8, rows/16, 4,
    32, 4), plane q = re big, re small, im big, im small."""
    parts = _parts(m, rows, cols)
    return torch.stack([p for part in parts
                        for p in tf32_split(_tf32_a_frags(part))], 2)


def tf32_tables(fz: torch.Tensor, fy: torch.Tensor):
    """K6's 3xTF32 operands from the complex64 tables Fz_t (Kzc, nz) and
    Fy_t (Ry, ny), split into tf32 big and small on their device (the
    layouts of csrc/transform3d_kernels.cu::zy_forward_tf32_kernel; nzp:
    nz rounded up to TF32_KZ, nyp: ny to TF32_TY, Kzc to BF16_KC, Ry to
    16, all zero-padded):

      fzt (nchunks, nzp/8, 2 BF16_KC/8, 32, 4): chunk c's z-stage B
          operand, rows n < BF16_KC of Re Fz_t[c BF16_KC + n, :], then Im,
          transposed (k = z), in fragment order (`_tf32_b_frags`);
      fya (nyp/8 + 1, rt, 4, 32, 4): Fy_t's re and im parts as A
          fragments (`_tf32_a_planes`), entry (s, r, q, lane) the tile at
          rows 16 r .., y = 8 s .. (one zero step past nyp, which the
          kernel prefetches).
    """
    kzc, nz = fz.shape
    ry, ny = fy.shape
    re, im = _parts(fz, _up(kzc, BF16_KC), _up(nz, TF32_KZ))
    chunks = torch.cat([re.unflatten(0, (-1, BF16_KC)),
                        im.unflatten(0, (-1, BF16_KC))], 1)
    fzt = _tf32_b_frags(chunks.transpose(1, 2))
    fya = _tf32_a_planes(fy, _up(ry, 16), _up(ny, TF32_TY) + 8)
    return fzt.contiguous(), fya.contiguous()


def inverse_tf32_tables(fyi: torch.Tensor, bz: torch.Tensor):
    """K7's 3xTF32 operands from the complex64 tables Fyi_t (ny, Ry) and
    Bz (Kzc, nz), split into tf32 big and small on their device (the
    layouts of csrc/transform3d_kernels.cu::yz_inverse_tf32_kernel; nyp:
    ny rounded up to TF32_INV_TY, Ry up to 8, Kzc up to the instance's
    8 NT (kpn, `_inv_nt`), nz up to 32, all zero-padded):

      fia (nyp/16, Ry/8, 4, 32, 4): Fyi_t's re and im parts as A
          fragments (`_tf32_a_planes`), by row tile first: entry (m, s, q,
          lane) the tile at rows y = 16 m .., columns 8 s ..;
      bzt (2 kpn/8, nzp/8, 32, 4): [Bz_re; -Bz_im] (2 kpn, nzp) as B
          fragments (`_tf32_b_frags`).
    """
    ny, ry = fyi.shape
    kzc, nz = bz.shape
    kpn = 8 * _inv_nt(kzc)
    fia = _tf32_a_planes(fyi, _up(ny, TF32_INV_TY), _up(ry, 8)).transpose(0, 1)
    re, im = _parts(bz, kpn, _up(nz, 32))
    return fia.contiguous(), _tf32_b_frags(torch.cat([re, -im])).contiguous()


_TABLES: dict = {}


def _cached(build, *tables: torch.Tensor):
    """build(*tables), kept for the same table tensors: the solver passes
    one set per (config, device) on every call. Holding the tensors keeps
    their ids from being reused while the entry lives."""
    key = (build, *map(id, tables))
    hit = _TABLES.get(key)
    if hit is None:
        if len(_TABLES) >= 16:
            _TABLES.clear()
        hit = _TABLES[key] = (tables, build(*tables))
    return hit[1]


def fused_zy_forward(w: torch.Tensor, Fz_t, Fy_t,
                     precision: str = "high") -> torch.Tensor:
    """(..., nx, ny, nz) real -> (..., nx, Ry, Kzc) complex: the z and y DFT
    stages of the compact forward transform in one launch, with the
    z-to-y intermediate kept on chip (K6). The x-stage is the caller's.
    At 'default' it runs on the tensor cores (bf16 operands, counted in
    `launches_bf16` too), at 'high'/'highest' on them as 3xTF32 (counted
    in `launches_tf32` too)."""
    return torch.ops.ns_tpu.fused_zy_forward.default(
        w, _table(Fz_t, w), _table(Fy_t, w), precision)


def _zy_forward_cuda(w, Fz_t, Fy_t, precision):
    _build.check_fields("fused_zy_forward", w, torch.float32, (3, 4, 5))
    fz, fy = _table(Fz_t, w), _table(Fy_t, w)
    lead, (nx, ny, nz) = w.shape[:-3], w.shape[-3:]
    kzc, ry = fz.shape[0], fy.shape[0]
    if fz.shape != (kzc, nz) or fy.shape != (ry, ny):
        raise ValueError(f"fused_zy_forward: tables {tuple(fz.shape)}, "
                         f"{tuple(fy.shape)} do not match w {tuple(w.shape)}")
    dims = dict(nx=nx, ny=ny, nz=nz, ry=ry, kzc=kzc)
    _check_fit("fused_zy_forward", dims, precision)
    B = int(np.prod(lead, dtype=np.int64))
    out = torch.empty((*lead, nx, ry, kzc), dtype=torch.complex64,
                      device=w.device)
    bf16 = precision == "default"
    if bf16:
        a, b = _cached(bf16_tables, fz, fy)
        fn = _build.entry("ns_fused_zy_forward_bf16", torch.float32)
    else:
        a, b = _cached(tf32_tables, fz, fy)
        fn = _build.entry("ns_fused_zy_forward", torch.float32)
    with torch.cuda.device(w.device):
        code = fn(w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  B, nx, ny, nz, ry, kzc, _build.stream(w.device))
    _build.check(code, "fused_zy_forward")
    fused_zy_forward.launches += 1
    fused_zy_forward.calls += 1
    fused_zy_forward.launches_bf16 += bf16
    fused_zy_forward.launches_tf32 += not bf16
    return out


fused_zy_forward.launches = 0
fused_zy_forward.calls = 0
fused_zy_forward.launches_bf16 = 0
fused_zy_forward.launches_tf32 = 0


def fused_yz_inverse(a: torch.Tensor, Fyi_t, Bz, nz: int,
                     precision: str = "high") -> torch.Tensor:
    """(..., nx, Ry, Kzc) complex -> (..., nx, ny, nz) real: the y-inverse
    and the z-unfold (real part only) in one launch (K7). The caller has
    run the x-inverse. At 'default' it runs on the tensor cores (bf16
    operands, counted in `launches_bf16` too), at 'high'/'highest' on them
    as 3xTF32 (counted in `launches_tf32` too)."""
    return torch.ops.ns_tpu.fused_yz_inverse.default(
        a, _table(Fyi_t, a), _table(Bz, a), int(nz), precision)


def _yz_inverse_cuda(a, Fyi_t, Bz, nz, precision):
    _build.check_fields("fused_yz_inverse", a, torch.complex64, (3, 4, 5))
    fyi, bz = _table(Fyi_t, a), _table(Bz, a)
    lead, (nx, ry, kzc) = a.shape[:-3], a.shape[-3:]
    ny = fyi.shape[0]
    if fyi.shape != (ny, ry) or bz.shape != (kzc, nz):
        raise ValueError(f"fused_yz_inverse: tables {tuple(fyi.shape)}, "
                         f"{tuple(bz.shape)} do not match a {tuple(a.shape)}"
                         f" and nz={nz}")
    dims = dict(nx=nx, ny=ny, nz=nz, ry=ry, kzc=kzc)
    _check_fit("fused_yz_inverse", dims, precision)
    B = int(np.prod(lead, dtype=np.int64))
    out = torch.empty((*lead, nx, ny, nz), dtype=torch.float32,
                      device=a.device)
    bf16 = precision == "default"
    if bf16:
        tables = _cached(inverse_tables, fyi, bz)
        fn = _build.entry("ns_fused_yz_inverse_bf16", torch.float32)
    else:
        tables = _cached(inverse_tf32_tables, fyi, bz)
        fn = _build.entry("ns_fused_yz_inverse", torch.float32)
    with torch.cuda.device(a.device):
        code = fn(_real_view(a).data_ptr(), *(t.data_ptr() for t in tables),
                  out.data_ptr(), B, nx, ny, nz, ry, kzc,
                  _build.stream(a.device))
    _build.check(code, "fused_yz_inverse")
    fused_yz_inverse.launches += 1
    fused_yz_inverse.calls += 1
    fused_yz_inverse.launches_bf16 += bf16
    fused_yz_inverse.launches_tf32 += not bf16
    return out


fused_yz_inverse.launches = 0
fused_yz_inverse.calls = 0
fused_yz_inverse.launches_bf16 = 0
fused_yz_inverse.launches_tf32 = 0


def fused_lamb(a6: torch.Tensor, Fyi_t, Bz, Fz_t, Fy_t, nz: int,
               precision: str = "default") -> torch.Tensor:
    """(6, nx, Ry, Kzc) complex (u, omega) after the x-inverse ->
    (3, nx, Ry, Kzc) complex u x omega before the x-forward: the whole
    physical leg of the nonlinear term (K8). Its two CUDA launches pass
    only the z-reduced products between them: in bf16 at 'default'
    (tensor cores, counted in `launches_bf16` too), as fp32 big and small
    tf32 planes at 'high'/'highest' (3xTF32 on the tensor cores, counted
    in `launches_tf32` too); no physical field is written to device
    memory."""
    return torch.ops.ns_tpu.fused_lamb.default(
        a6, _table(Fyi_t, a6), _table(Bz, a6), _table(Fz_t, a6),
        _table(Fy_t, a6), int(nz), precision)


def _lamb_cuda(a6, Fyi_t, Bz, Fz_t, Fy_t, nz, precision):
    _build.check_fields("fused_lamb", a6, torch.complex64, (4,))
    if a6.shape[0] != 6:
        raise ValueError(f"fused_lamb wants (6, nx, Ry, Kzc); got "
                         f"{tuple(a6.shape)}")
    fyi, bz = _table(Fyi_t, a6), _table(Bz, a6)
    fz, fy = _table(Fz_t, a6), _table(Fy_t, a6)
    _, nx, ry, kzc = a6.shape
    ny = fyi.shape[0]
    if (fyi.shape != (ny, ry) or bz.shape != (kzc, nz)
            or fz.shape != (kzc, nz) or fy.shape != (ry, ny)):
        raise ValueError("fused_lamb: DFT tables do not match a6 "
                         f"{tuple(a6.shape)} and nz={nz}")
    dims = dict(nx=nx, ny=ny, nz=nz, ry=ry, kzc=kzc)
    _check_fit("fused_lamb", dims, precision)
    out = torch.empty((3, nx, ry, kzc), dtype=torch.complex64,
                      device=a6.device)
    bf16 = precision == "default"
    if bf16:
        tables = _cached(lamb_tables, fyi, bz, fz, fy)
        scratch = torch.empty((3, nx, _up(ny, INV_TY), 2 * _up(kzc, 16)),
                              dtype=torch.bfloat16, device=a6.device)
        fn = _build.entry("ns_fused_lamb_bf16", torch.float32)
    else:
        tables = (*_cached(inverse_tf32_tables, fyi, bz),
                  *_cached(tf32_tables, fz, fy))
        # S: t1 of each (component, slab), by Kzc chunk, big and small
        # planes of 2 BF16_KC columns, y along the rows
        scratch = torch.empty((3, nx, -(-kzc // BF16_KC), 2, 2 * BF16_KC,
                               _up(ny, TF32_TY)), dtype=torch.float32,
                              device=a6.device)
        fn = _build.entry("ns_fused_lamb", torch.float32)
    with torch.cuda.device(a6.device):
        code = fn(_real_view(a6).data_ptr(), *(t.data_ptr() for t in tables),
                  scratch.data_ptr(), out.data_ptr(), nx, ny, nz, ry, kzc,
                  _build.stream(a6.device))
    _build.check(code, "fused_lamb")
    fused_lamb.launches += 1
    fused_lamb.calls += 1
    fused_lamb.launches_bf16 += bf16
    fused_lamb.launches_tf32 += not bf16
    return out


fused_lamb.launches = 0
fused_lamb.calls = 0
fused_lamb.launches_bf16 = 0
fused_lamb.launches_tf32 = 0
