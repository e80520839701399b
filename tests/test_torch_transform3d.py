"""The 3D transforms of the port (ns_tpu_torch.solvers.spectral3d and the
K6-K8 twins in ops/kernels/transform3d_kernels.py) against ns_tpu, on the
CPU, on the same numpy inputs.

Tolerances: float64 (fft engine, and the matmul engine at 'highest') <=
1e-10 relative to the output's scale: the same DFT sums, taken in another
order (real GEMM pairs here, complex einsums in JAX). The fused route in
float32 at 'highest' on both sides (the JAX side runs its Pallas kernels in
interpret mode): rtol 1e-4, atol 1e-5 * max, the bounds of
tests/test_pallas_transform3d.py; float32 sums in another order differ at
~1e-7 relative, far inside them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.ops.pallas import transform3d_kernels as jk
from ns_tpu.solvers import spectral3d as j3
from ns_tpu_torch.ops import kernels
from ns_tpu_torch.ops.kernels import transform3d_kernels as tk
from ns_tpu_torch.solvers import spectral3d as t3

SHAPES = [(16, 16, 16), (12, 18, 12)]


def cfgs(shape, **kw):
    kw = dict(dict(zip(("nx", "ny", "nz"), shape)), **kw)
    return j3.Spectral3DConfig(**kw), t3.Spectral3DConfig(**kw)


def close(got, want, rel):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale)


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("transform", ["fft", "matmul"])
def test_transforms_match_jax_float64(shape, transform):
    jc, tc = cfgs(shape, dtype="float64", transform=transform,
                  matmul_precision="highest")
    w = rand((2, *shape), 0)
    jf, ji = j3.make_transforms(jc)
    tf, ti = t3.make_transforms(tc)
    z_j = np.array(jax.jit(jf)(jnp.asarray(w)))
    z_t = tf(torch.as_tensor(w)).numpy()
    close(z_t, z_j, 1e-10)
    close(ti(torch.as_tensor(z_j)).numpy(), jax.jit(ji)(jnp.asarray(z_j)),
          1e-10)
    if transform == "matmul":
        full_j = j3.expand_compact(jc, jnp.asarray(z_j))
        full_t = t3.expand_compact(tc, torch.as_tensor(z_j))
        np.testing.assert_array_equal(full_t.numpy(), np.asarray(full_j))
        np.testing.assert_array_equal(
            t3.gather_compact(tc, full_t).numpy(), z_j)


@pytest.mark.parametrize("kw", [
    dict(transform="fft"), dict(transform="fft", dealias=False),
    dict(transform="matmul"),
    dict(transform="matmul", forcing="kolmogorov", forcing_k=2,
         forcing_amp=0.3)])
def test_make_ops_and_dft_constants_match_jax(kw):
    jc, tc = cfgs((12, 18, 12), dtype="float64", **kw)
    j_ops, t_ops = j3.make_ops(jc), t3.make_ops(tc)
    assert sorted(j_ops) == sorted(t_ops)
    for k in j_ops:
        np.testing.assert_array_equal(t_ops[k].numpy(), np.asarray(j_ops[k]))
    if tc.compact:
        for k, v in j3._dft_constants_np(jc).items():
            np.testing.assert_array_equal(t3._dft_constants_np(tc)[k], v)
        jm, tm = j3._compact_meta(jc), t3._compact_meta(tc)
        np.testing.assert_array_equal(jm[0], tm[0])
        np.testing.assert_array_equal(jm[1], tm[1])
        assert jm[2] == tm[2]


def fused_cfgs(n=16):
    kw = dict(nx=n, ny=n, nz=n, dtype="float32", transform="matmul",
              matmul_precision="highest")
    jc = dataclasses.replace(j3.Spectral3DConfig(**kw),
                             use_pallas_transform=True, pallas_interpret=True)
    return jc, t3.Spectral3DConfig(use_pallas_transform=True, **kw)


def test_fused_forward_and_inverse_match_jax_interpret():
    """K6 (forward) and K7 (inverse) through the fused engine: the port's
    twins against the JAX Pallas kernels in interpret mode, 16^3 f32."""
    jc, tc = fused_cfgs()
    w = rand((2, 16, 16, 16), 0).astype(np.float32)
    jf, ji = j3.make_compact_transforms(jc)
    tf, ti = t3.make_compact_transforms(tc)
    z_j = np.array(jax.jit(jf)(jnp.asarray(w)))
    z_t = tf(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(z_t, z_j, rtol=1e-4,
                               atol=1e-5 * np.abs(z_j).max())
    w_j = np.asarray(jax.jit(ji)(jnp.asarray(z_j)))
    w_t = ti(torch.as_tensor(z_j)).numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4,
                               atol=1e-5 * np.abs(w_j).max())


def test_fused_lamb_matches_jax_interpret_and_einsum_path():
    """K8's twin on the same (6, nx, Ry, Kzc) input as the JAX fused_lamb
    in interpret mode, and against the port's plain nonlinear path
    (inverse all six, cross product, forward)."""
    jc, tc = fused_cfgs()
    M = t3._dft_constants_np(tc)
    _, rows_y, kzc = t3._compact_meta(tc)
    rng = np.random.default_rng(3)
    a6 = (rng.standard_normal((6, 16, len(rows_y), kzc))
          + 1j * rng.standard_normal((6, 16, len(rows_y), kzc))
          ).astype(np.complex64)
    want = np.asarray(jk.fused_lamb(jnp.asarray(a6), M["Fyi_t"], M["Bz"],
                                    M["Fz_t"], M["Fy_t"], 16,
                                    precision="highest", interpret=True))
    got = tk.fused_lamb(torch.as_tensor(a6), M["Fyi_t"], M["Bz"], M["Fz_t"],
                        M["Fy_t"], 16, precision="highest").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    # the same leg by the plain chain's stages, and the launch counters
    # stay at zero on the CPU
    phys = tk.yz_inverse(torch.as_tensor(a6), M["Fyi_t"], M["Bz"], 16,
                         "highest")
    plain = tk.zy_forward(tk.cross(phys), M["Fz_t"], M["Fy_t"], "highest")
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert set(kernels.launch_counts().values()) == {0}


def test_fused_step_matches_jax_fused_step(monkeypatch):
    """One IF-AB2 step of the fused route, 16^3 f32 'highest': the port
    (twins on the CPU, K8 once per step) against the JAX fused step in
    interpret mode, from the same IC."""
    jc, tc = fused_cfgs()
    u0 = t3.random_solenoidal_velocity(tc, seed=1, k_peak=3.0)
    step_j, _ = j3.make_step(jc)
    c1_j = jax.jit(lambda c: step_j(c)[0])(j3.init_from_velocity(jc, u0))
    calls = []
    real = tk.fused_lamb
    monkeypatch.setattr(tk, "fused_lamb",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    step_t, _ = t3.make_step(tc)
    c1_t, _ = step_t(t3.init_from_velocity(tc, u0, "cpu"))
    assert len(calls) == 2  # carry init's nonlinear term, then the step
    for got, want in zip(t3.carry_to_numpy(c1_t), t3.carry_to_numpy(c1_j)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_fused_auto_gate_matches_jax_policy():
    """'auto' resolves as in test_pallas_transform_auto_policy: on at
    256^3, 352^3 and 512x256x128 with 'default' precision, off below the
    volume crossover, at 'high', or on the fft engine. The port's volume
    crossover is 128^3 where JAX's is 256^3: on the H100 the fused
    'default' step loop ran 2.9-3.2x the plain one at 128^3 (1.8x at
    256^3), so 128^3 fuses in the port and not in JAX; 512^3 resolves off
    (K8's block does not fit shared memory) and explicit True there
    raises; float64 and the fft engine are refused. At 'default' the
    tensor-core kernels fit where the fp32 ones do not, so the port fuses
    352^3 as JAX does; K8's tensor-core kernel, which holds a slab's
    spectrum and six fields' y-inverse in shared memory, binds at 384^3
    and 416^3, which the port fused while K8 ran its fp32 kernel at
    'default' and which now resolve off, as the TPU's VMEM check has
    them."""
    for kw, on, on_jax in (
            (dict(nx=256, ny=256, nz=256), True, True),
            (dict(nx=352, ny=352, nz=352), True, True),
            (dict(nx=384, ny=384, nz=384), False, False),
            (dict(nx=416, ny=416, nz=416), False, False),
            (dict(nx=448, ny=448, nz=448), False, False),
            (dict(nx=512, ny=256, nz=128), True, True),
            (dict(nx=128, ny=128, nz=128), True, False),
            (dict(nx=96, ny=96, nz=96), False, False),
            (dict(nx=256, ny=16, nz=16), False, False),
            (dict(nx=256, ny=256, nz=256, matmul_precision="high"), False,
             False),
            (dict(nx=256, ny=256, nz=256, transform="fft", dealias=False),
             False, False),
            (dict(nx=512, ny=512, nz=512), False, False)):
        kw = dict(dict(transform="matmul", matmul_precision="default"), **kw)
        j = j3.Spectral3DConfig(use_pallas_transform="auto", **kw)
        t = t3.Spectral3DConfig(use_pallas_transform="auto", **kw)
        assert t.use_pallas_transform is on, kw
        assert j.use_pallas_transform is on_jax, kw
    with pytest.raises(ValueError, match="shared memory"):
        t3.Spectral3DConfig(nx=512, ny=512, nz=512, transform="matmul",
                            use_pallas_transform=True)
    for kw in (dict(transform="fft"), dict(transform="matmul",
                                           dtype="float64")):
        with pytest.raises(ValueError, match="use_pallas_transform"):
            t3.Spectral3DConfig(nx=16, ny=16, nz=16,
                                use_pallas_transform=True, **kw)
    with pytest.raises(ValueError, match="use_pallas_transform"):
        t3.Spectral3DConfig(transform="matmul", use_pallas_transform="yes")
    # the kernels' own fit: 256^3 needs 194,560 bytes in the 3xTF32 K6's
    # block (at any grid) and 188,416 in the 3xTF32 K7's, which binds at
    # 'high'/'highest' (the 3xTF32 K8's first launch needs 172,032);
    # 124,928 in the tensor-core K6's, 83,200 in K7's and 147,200 in K8's;
    # 352^3 fits only at 'default' (K8: 228,096 bytes; the 3xTF32 K7 needs
    # 253,952, the 3xTF32 K8 233,472), 384^3 (K8: 236,544) does not
    k = tk.smem_bytes(256, 256, 256, 171, 86)
    assert (k["fused_zy_forward"], k["fused_yz_inverse"],
            k["fused_lamb"]) == (194560, 188416, 172032)
    k = tk.smem_bytes(352, 352, 352, 235, 118, "highest")
    assert (k["fused_yz_inverse"], k["fused_lamb"]) == (253952, 233472)
    assert tk.smem_bytes(256, 256, 256, 171, 86,
                         "default")["fused_zy_forward"] == 124928
    k = tk.smem_bytes(256, 256, 256, 171, 86, "default")
    assert (k["fused_yz_inverse"], k["fused_lamb"]) == (83200, 147200)
    assert tk.smem_bytes(352, 352, 352, 235, 118,
                         "default")["fused_lamb"] == 228096
    assert not tk.fused_fits(384, 384, 384, 255, 128, "default")
    assert tk.fused_fits(256, 256, 256, 171, 86)
    assert not tk.fused_fits(352, 352, 352, 235, 118, "highest")
    assert tk.fused_fits(352, 352, 352, 235, 118, "default")
    assert not tk.fused_fits(512, 512, 512, 341, 171)
    assert not tk.fused_fits(512, 512, 512, 341, 171, "default")
    with pytest.raises(ValueError, match="shared memory"):
        t3.Spectral3DConfig(nx=352, ny=352, nz=352, transform="matmul",
                            matmul_precision="highest",
                            use_pallas_transform=True)


def test_k8_tf32_fits_wherever_k7_does():
    """The 3xTF32 K8 streams the spectrum instead of holding it, so its
    block fits wherever the 3xTF32 K7's does and needs less wherever K7's
    needs more than K8's second launch (K6's y-stage on two S tiles):
    fused_fits at 'high' is K7's check, on cubic grids 8^3 .. 400^3 and
    on slabs whose y or z extent alone grows (Ry, Kzc by the 2/3 rule)."""
    def dims(nx, ny, nz):
        cfg = t3.Spectral3DConfig(nx=nx, ny=ny, nz=nz, transform="matmul")
        _, rows_y, kzc = t3._compact_meta(cfg)
        return nx, ny, nz, len(rows_y), kzc

    grids = ([(n, n, n) for n in range(8, 401, 8)]
             + [(64, n, 64) for n in range(16, 1201, 48)]
             + [(64, 64, n) for n in range(16, 401, 12)])
    fits = 0
    for grid in grids:
        d = dims(*grid)
        k = tk.smem_bytes(*d, "high")
        k7_fits = k["fused_yz_inverse"] <= tk.SMEM_BUDGET
        assert tk.fused_fits(*d, "high") == k7_fits, grid
        if k7_fits:
            fits += 1
            assert k["fused_lamb"] <= max(k["fused_yz_inverse"],
                                          tk.LAMB_YFWD_SMEM), grid
    assert 0 < fits < len(grids)


# --- K6 at 'default': the tensor-core kernel's spec -------------------------

def bf(x):
    """x rounded to bf16 (RNE) through float32, as float64."""
    return (torch.as_tensor(np.asarray(x, dtype=np.float32))
            .to(torch.bfloat16).to(torch.float64).numpy())


def bf_c(z):
    return bf(z.real) + 1j * bf(z.imag)


def k6_default_emulation(w, Fz_t, Fy_t):
    """The rounding points of K6 at 'default' (the TPU's DEFAULT): w and
    Fz_t rounded to bf16, t in float64 then rounded to bf16 once, Fy_t
    rounded to bf16, the y-stage in float64."""
    t = bf(w) @ bf_c(Fz_t).T
    return bf_c(Fy_t) @ bf_c(t)


def k6_case(shape, seed=0, batch=3):
    nx, ny, nz = shape
    cfg = t3.Spectral3DConfig(nx=nx, ny=ny, nz=nz, transform="matmul")
    M = {k: v.astype(np.complex64) for k, v in
         t3._dft_constants_np(cfg).items()}
    w = rand((batch, *shape), seed).astype(np.float32)
    return w, M


def rel_err(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(16, 16, 16), (40, 36, 30)])
def test_k6_default_twin_has_the_tpu_default_rounding_points(shape):
    """The twin zy_forward at 'default' (the spec of K6's tensor-core
    kernel) against a numpy emulation of the rounding points, batch 3:
    <= 5e-4 of max|out|. The gap is rare one-ulp bf16 flips of t from the
    order of the fp32 sums (<= ~2.5e-4 reckoned); rounding a GEMM output
    to bf16 as well would give ~3e-3."""
    w, M = k6_case(shape)
    want = k6_default_emulation(w, M["Fz_t"], M["Fy_t"])
    got = tk.zy_forward(torch.as_tensor(w), M["Fz_t"], M["Fy_t"], "default")
    assert got.dtype == torch.complex64
    assert rel_err(got.numpy(), want) <= 5e-4


@pytest.mark.parametrize("shape", [(16, 16, 16), (40, 36, 30)])
def test_k6_default_twin_near_jax_highest(shape):
    """The twin at 'default' against JAX's fused_zy_forward at 'highest'
    (interpret mode): <= 2e-2 of max|out|, the four bf16 roundings (w,
    Fz_t, t, Fy_t; ~2.5e-3 each) being the only gap."""
    w, M = k6_case(shape, seed=1)
    want = np.asarray(jk.fused_zy_forward(jnp.asarray(w), M["Fz_t"],
                                          M["Fy_t"], precision="highest",
                                          interpret=True))
    got = tk.zy_forward(torch.as_tensor(w), M["Fz_t"], M["Fy_t"], "default")
    assert rel_err(got.numpy(), want) <= 2e-2


def k6_from_tables(w, fzb, afrag, ny, ry, kzc):
    """K6's tensor-core kernel step by step on the operands it is given
    (bf16_tables), in float64: per Kzc chunk, the z-stage against the
    chunk's Fz rows, t rounded to bf16, then per y-tile and k-step the A
    tile of the block matrix [[Fy_re, -Fy_im], [Fy_im, Fy_re]], built from
    the Fy_re and Fy_im tiles unpacked from their fragment order as the
    kernel builds it, times the t rows the kernel reads at that step."""
    fzb = fzb.to(torch.float64).numpy()
    afrag = afrag.to(torch.float64).numpy()
    nch, n1, nzp = fzb.shape
    nyt, rt = afrag.shape[:2]
    ryp, kc = rt * 16, n1 // 2
    row, col = (i.numpy() for i in tk._frag_index(torch.device("cpu")))
    wp = np.zeros(w.shape[:-2] + (nyt * tk.BF16_TY, nzp))
    wp[..., :ny, :w.shape[-1]] = bf(w)
    out = np.zeros(w.shape[:-2] + (ry, kzc), np.complex128)
    for c in range(nch):
        t = bf(wp @ fzb[c].T)
        acc = np.zeros(w.shape[:-2] + (2 * ryp, kc))
        for j in range(nyt):
            for s in range(4):
                f = np.zeros((2, rt, 16, 16))  # Fy_re, Fy_im row tiles
                for q in range(2):
                    f[q][:, row, col] = afrag[j, :, s % 2, q]
                re, im = f.reshape(2, ryp, 16)
                a = np.concatenate([re, im] if s < 2 else [-im, re])
                y0 = j * tk.BF16_TY + (s % 2) * 16
                acc += a @ t[..., y0:y0 + 16, (s // 2) * kc:(s // 2 + 1) * kc]
        k1 = min(kzc, (c + 1) * kc)
        n = k1 - c * kc
        out[..., c * kc:k1] = acc[..., :ry, :n] + 1j * acc[..., ryp:ryp + ry,
                                                           :n]
    return out


@pytest.mark.parametrize("shape", [(16, 16, 16), (40, 36, 30), (24, 70, 20)])
def test_k6_bf16_tables_feed_the_kernel_its_spec(shape):
    """The operands the wrapper lays out for the tensor-core kernel
    (bf16_tables: Fz rows by chunk, the y-stage block matrix in mma
    fragment order), read as the kernel reads them, give the emulation of
    the rounding points: <= 1e-6 of max|out| (the same bf16 values, summed
    in float64 in another order). 24x70x20 has several y-tiles, a ragged
    last one, and Kzc = 7."""
    w, M = k6_case(shape, seed=2)
    fz = torch.as_tensor(M["Fz_t"])
    fy = torch.as_tensor(M["Fy_t"])
    fzb, afrag = tk.bf16_tables(fz, fy)
    assert fzb.dtype == afrag.dtype == torch.bfloat16
    ry, kzc = fy.shape[0], fz.shape[0]
    got = k6_from_tables(w, fzb, afrag, shape[1], ry, kzc)
    want = k6_default_emulation(w, M["Fz_t"], M["Fy_t"])
    assert rel_err(got, want) <= 1e-6


# --- K7 and K8 at 'default': the tensor-core kernels' spec ------------------

def k7_default_emulation(a, Fyi_t, Bz):
    """The rounding points of K7 at 'default' (the TPU's DEFAULT): a and
    Fyi_t rounded to bf16, t in float64 then rounded to bf16 once, Bz
    rounded to bf16, the z-unfold in float64."""
    t = bf_c(bf_c(Fyi_t) @ bf_c(a))
    return t.real @ bf(Bz.real) - t.imag @ bf(Bz.imag)


def k8_default_emulation(a6, M):
    """K8 at 'default': K7's rounding points on each of the six fields,
    u x omega in float64, then K6's on the three products."""
    phys = np.stack([k7_default_emulation(f, M["Fyi_t"], M["Bz"])
                     for f in a6])
    u1, u2, u3, w1, w2, w3 = phys
    lam = np.stack([u2 * w3 - u3 * w2, u3 * w1 - u1 * w3, u1 * w2 - u2 * w1])
    return k6_default_emulation(lam, M["Fz_t"], M["Fy_t"])


def spectra(shape, seed, nf):
    """nf complex64 spectra (nf, nx, Ry, Kzc) of the grid, and its tables."""
    _, M = k6_case(shape)
    ry, kzc = M["Fy_t"].shape[0], M["Fz_t"].shape[0]
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((nf, shape[0], ry, kzc))
         + 1j * rng.standard_normal((nf, shape[0], ry, kzc)))
    return a.astype(np.complex64), M


@pytest.mark.parametrize("shape", [(16, 16, 16), (40, 36, 30)])
def test_k7_k8_default_twins_have_the_tpu_default_rounding_points(shape):
    """The twins yz_inverse and lamb at 'default' (the specs of K7's and
    K8's tensor-core kernels) against numpy emulations of the rounding
    points: <= 5e-4 of max|out|. As for K6, the gap is rare one-ulp bf16
    flips of t (and of K8's products and t1) from the order of the fp32
    sums."""
    a6, M = spectra(shape, 4, 6)
    want = k7_default_emulation(a6[:2], M["Fyi_t"], M["Bz"])
    got = tk.yz_inverse(torch.as_tensor(a6[:2]), M["Fyi_t"], M["Bz"],
                        shape[2], "default")
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 5e-4
    want = k8_default_emulation(a6, M)
    got = tk.lamb(torch.as_tensor(a6), M["Fyi_t"], M["Bz"], M["Fz_t"],
                  M["Fy_t"], shape[2], "default")
    assert got.dtype == torch.complex64
    assert rel_err(got.numpy(), want) <= 5e-4


@pytest.mark.parametrize("shape", [(16, 16, 16), (40, 36, 30)])
def test_k7_k8_default_twins_near_jax_highest(shape):
    """The twins at 'default' against JAX's fused_yz_inverse and
    fused_lamb at 'highest' (interpret mode). The bf16 roundings are the
    only gap, each <= 2^-9 of its operand, ~2^-8 of max|out| with the
    sums' spread: K7 has four (a, Fyi_t, t, Bz), bound 2e-2 as for K6's
    four; K8 has K7's four in each factor of u x omega (eight on a
    product) and K6's four after it, twelve, bound 5e-2."""
    a6, M = spectra(shape, 5, 6)
    nz = shape[2]
    want = np.asarray(jk.fused_yz_inverse(jnp.asarray(a6[:1]), M["Fyi_t"],
                                          M["Bz"], nz, precision="highest",
                                          interpret=True))
    got = tk.yz_inverse(torch.as_tensor(a6[:1]), M["Fyi_t"], M["Bz"], nz,
                        "default")
    assert rel_err(got.numpy(), want) <= 2e-2
    want = np.asarray(jk.fused_lamb(jnp.asarray(a6), M["Fyi_t"], M["Bz"],
                                    M["Fz_t"], M["Fy_t"], nz,
                                    precision="highest", interpret=True))
    got = tk.lamb(torch.as_tensor(a6), M["Fyi_t"], M["Bz"], M["Fz_t"],
                  M["Fy_t"], nz, "default")
    assert rel_err(got.numpy(), want) <= 5e-2


def a_unpack(frags):
    """(..., 32, 8) mma A fragments -> (..., 16, 16) tiles: lane's register
    r holds (g + 8 (r % 2), 2 t + 8 (r // 2) + e), g = lane // 4,
    t = lane % 4, e the half of the register."""
    out = np.zeros(frags.shape[:-2] + (16, 16))
    for lane in range(32):
        for i in range(8):
            r, e = divmod(i, 2)
            out[..., lane // 4 + 8 * (r % 2),
                2 * (lane % 4) + 8 * (r // 2) + e] = frags[..., lane, i]
    return out


def b_unpack(frags):
    """(..., 32, 8) registers read as mma B fragments of two n-tiles, as
    the kernels read them (registers 0, 2: n-tile 0's b0, b1; 1, 3: n-tile
    1's) -> (..., 16 k, 16 n): b0 holds (k = 2 t + e, n = g), b1
    (k = 2 t + 8 + e, n = g)."""
    out = np.zeros(frags.shape[:-2] + (16, 16))
    for lane in range(32):
        for i in range(8):
            r, e = divmod(i, 2)
            out[..., 2 * (lane % 4) + 8 * (r // 2) + e,
                8 * (r % 2) + lane // 4] = frags[..., lane, i]
    return out


def tiles(t):
    """(C, R, 16, 16) tiles, by column tile and row tile -> one (16 R,
    16 C) matrix."""
    t = np.swapaxes(t, 0, 1)
    R, C = t.shape[:2]
    return t.transpose(0, 2, 1, 3).reshape(R * 16, C * 16)


def k7_from_tables(a, afi, bzf, ny, nz):
    """K7's tensor-core kernel step by step on the operands it is given
    (inverse_tables), in float64: Fyi_re and Fyi_im from their A fragments
    (by k-step s and row tile m), the slab's spectrum rounded to bf16 in
    the kernel's re | im layout, the block-form y-inverse, t rounded to
    bf16, and the z-unfold against [Bz_re; -Bz_im] read from its B
    fragments (by z pair and k-step)."""
    afi = afi.to(torch.float64).numpy()
    bzf = bzf.to(torch.float64).numpy()
    fr, fi = (tiles(a_unpack(afi[:, :, q])) for q in range(2))
    B = tiles(b_unpack(bzf))  # (2 kp, nzp)
    kp = B.shape[0] // 2
    ryp = fr.shape[1]
    ar = np.zeros(a.shape[:-2] + (ryp, kp))
    ai = np.zeros_like(ar)
    ar[..., :a.shape[-2], :a.shape[-1]] = bf(a.real)
    ai[..., :a.shape[-2], :a.shape[-1]] = bf(a.imag)
    t = np.concatenate([bf(fr @ ar - fi @ ai), bf(fi @ ar + fr @ ai)], -1)
    return (t @ B)[..., :ny, :nz]


def k8_from_tables(a6, tables, ny, nz, ry, kzc):
    """K8's two tensor-core launches step by step on lamb_tables' operands,
    in float64: K7's model on the six fields (padded rows and columns
    kept), u x omega, the products rounded to bf16, the z-forward against
    [Re Fz_t; Im Fz_t] read from its B fragments (by column pair and
    z-step), t1 rounded to bf16 (s), then K6's y-stage on s with Fy_t's
    fragments (k6_from_tables' reading)."""
    afi, bzf, fzf, afrag = tables
    nyp = afi.shape[1] * 16
    phys = np.stack([k7_from_tables(f, afi, bzf, nyp, 10**9) for f in a6])
    u1, u2, u3, w1, w2, w3 = phys
    lam = bf(np.stack([u2 * w3 - u3 * w2, u3 * w1 - u1 * w3,
                       u1 * w2 - u2 * w1]))
    s = bf(lam @ tiles(b_unpack(fzf.to(torch.float64).numpy())))
    kp = s.shape[-1] // 2
    afrag = afrag.to(torch.float64).numpy()
    nyt, rt = afrag.shape[:2]
    f = np.zeros((2, rt * 16, nyt * tk.BF16_TY))
    for j in range(nyt):
        for h in range(2):
            for q in range(2):
                y0 = j * tk.BF16_TY + 16 * h
                f[q][:, y0:y0 + 16] = a_unpack(afrag[j, :, h, q]).reshape(
                    rt * 16, 16)
    sr, si = s[..., :nyp, :kp], s[..., :nyp, kp:]
    fr, fi = f[0][:, :nyp], f[1][:, :nyp]
    out = (fr @ sr - fi @ si) + 1j * (fr @ si + fi @ sr)
    return out[..., :ry, :kzc]


@pytest.mark.parametrize("shape", [(16, 16, 16), (40, 36, 30), (24, 70, 20)])
def test_k7_k8_bf16_tables_feed_the_kernels_their_spec(shape):
    """The operands the wrappers lay out for K7's and K8's tensor-core
    kernels (inverse_tables, lamb_tables: Fyi_t as A fragments, Bz and
    Fz_t as B fragments, Fy_t as K6's), read as the kernels read them, give
    the emulations of the rounding points: <= 1e-6 of max|out| (the same
    bf16 values, summed in float64 in another order). 24x70x20 has Ry = 47
    and ny = 70 (ragged row tiles and y-tiles), Kzc = 7 and nz = 20 (both
    padded to 16)."""
    a6, M = spectra(shape, 6, 6)
    a6 = a6[:, :3]  # three x-slabs are enough for the layouts
    ny, nz = shape[1:]
    ry, kzc = M["Fy_t"].shape[0], M["Fz_t"].shape[0]
    T = {k: torch.as_tensor(M[k]) for k in ("Fyi_t", "Bz", "Fz_t", "Fy_t")}
    afi, bzf = tk.inverse_tables(T["Fyi_t"], T["Bz"])
    assert afi.dtype == bzf.dtype == torch.bfloat16
    assert afi.shape == (-(-ry // 16), -(-ny // 32) * 2, 2, 32, 8)
    assert bzf.shape == (-(-nz // 16), -(-kzc // 16) * 2, 32, 8)
    got = k7_from_tables(a6[0], afi, bzf, ny, nz)
    want = k7_default_emulation(a6[0], M["Fyi_t"], M["Bz"])
    assert rel_err(got, want) <= 1e-6
    tables = tk.lamb_tables(T["Fyi_t"], T["Bz"], T["Fz_t"], T["Fy_t"])
    got = k8_from_tables(a6, tables, ny, nz, ry, kzc)
    assert rel_err(got, k8_default_emulation(a6, M)) <= 1e-6


# --- K6 and K7 at 'high'/'highest': the 3xTF32 kernels' spec ----------------

def rna(x):
    """float32 x rounded to tf32 as cvt.rna.tf32.f32 rounds it: to nearest
    at 10 mantissa bits (13 dropped), ties away from zero."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split3(x):
    """float32 x as its tf32 (big, small) = (rna(x), rna(x - big)), in
    float64."""
    x = np.ascontiguousarray(x, np.float32)
    big = rna(x)
    return big.astype(np.float64), rna(x - big).astype(np.float64)


def x3(a, b):
    """a @ b at 3xTF32 on split operands (big, small), in float64: the two
    cross terms and the big product (small @ small dropped)."""
    return a[1] @ b[0] + a[0] @ b[1] + a[0] @ b[0]


def neg(a):
    return -a[0], -a[1]


def tf32_a_unpack(frags):
    """(..., C/8, R/16, 32, 4) A fragments of the 3xTF32 kernels -> (...,
    R, C): register i of lane holds (16 r + g + 8 (i % 2), 8 s + 2 tq +
    i // 2), g = lane // 4, tq = lane % 4."""
    *lead, S, Rt, _, _ = frags.shape
    out = np.zeros((*lead, Rt * 16, S * 8))
    for lane in range(32):
        g, tq = divmod(lane, 4)
        for i in range(4):
            out[..., g + 8 * (i % 2)::16, 2 * tq + i // 2::8] = np.swapaxes(
                frags[..., lane, i], -1, -2)
    return out


def tf32_b_unpack(frags):
    """(..., K/8, N/8, 32, 4) B fragments (b0 big, b1 big, b0 small, b1
    small) -> (big, small), each (..., K, N): b_i of lane is (8 s + 2 tq +
    i, 8 n + g)."""
    *lead, S, Nt, _, _ = frags.shape
    big = np.zeros((*lead, S * 8, Nt * 8))
    small = np.zeros_like(big)
    for lane in range(32):
        g, tq = divmod(lane, 4)
        for i in range(2):
            big[..., 2 * tq + i::8, g::8] = frags[..., lane, i]
            small[..., 2 * tq + i::8, g::8] = frags[..., lane, 2 + i]
    return big, small


def k6_tf32_from_tables(w, fzt, fya, ny, ry, kzc):
    """K6's 3xTF32 kernel step by step on the operands it is given
    (tf32_tables), in float64: per Kzc chunk, the z-stage against the
    chunk's Fz planes read from their B fragments (w split as the kernel
    splits it after each load), t rounded to float32 (its fp32
    accumulator) and split into its planes, then the y-stage on the block
    matrix [[Fy_re, -Fy_im], [Fy_im, Fy_re]] of the Fy planes read from
    their A fragments (-Fy_im: both planes' signs flipped)."""
    fzt, fya = fzt.numpy(), fya.numpy()
    Bb, Bs = tf32_b_unpack(fzt)  # (nchunks, nzp, 2 kc)
    F = [tf32_a_unpack(fya[:, :, q]) for q in range(4)]  # (ryp, nyp)
    fr, fi = (F[0], F[1]), (F[2], F[3])
    nzp, nyp, kc = Bb.shape[1], F[0].shape[1], Bb.shape[2] // 2
    wp = np.zeros(w.shape[:-2] + (nyp, nzp), np.float32)
    wp[..., :ny, :w.shape[-1]] = w
    ws = split3(wp)
    out = np.zeros(w.shape[:-2] + (ry, kzc), np.complex128)
    for c in range(Bb.shape[0]):
        t = split3(x3(ws, (Bb[c], Bs[c])).astype(np.float32))
        tr = (t[0][..., :kc], t[1][..., :kc])
        ti = (t[0][..., kc:], t[1][..., kc:])
        re = x3(fr, tr) + x3(neg(fi), ti)
        im = x3(fi, tr) + x3(fr, ti)
        k1 = min(kzc, (c + 1) * kc)
        out[..., c * kc:k1] = (re + 1j * im)[..., :ry, :k1 - c * kc]
    return out


def k6_tf32_direct(w, Fz_t, Fy_t):
    """The same arithmetic straight from the float32 tables: x3 of the
    split w and Fz_t's parts, t rounded to float32 and split, x3 with the
    split parts of Fy_t."""
    ws = split3(w)
    tr = split3(x3(ws, split3(Fz_t.real.T)).astype(np.float32))
    ti = split3(x3(ws, split3(Fz_t.imag.T)).astype(np.float32))
    fr, fi = split3(Fy_t.real), split3(Fy_t.imag)
    return (x3(fr, tr) + x3(neg(fi), ti)) + 1j * (x3(fi, tr) + x3(fr, ti))


def k7_tf32_from_tables(a, fia, bzt, ny, nz):
    """K7's 3xTF32 kernel step by step on the operands it is given
    (inverse_tf32_tables), in float64: the Fyi planes from their A
    fragments (by row tile, then k-step), the slab's spectrum zero-padded
    and split as loaded, the block-form y-inverse, t rounded to float32 and
    split into its [t_re | t_im] planes, and the z-unfold against [Bz_re;
    -Bz_im] read from its B fragments."""
    fia = fia.numpy()
    F = [tf32_a_unpack(np.swapaxes(fia[:, :, q], 0, 1)) for q in range(4)]
    fr, fi = (F[0], F[1]), (F[2], F[3])
    Bb, Bs = tf32_b_unpack(bzt.numpy())  # (2 kpn, nzp)
    ryp, kpn = F[0].shape[1], Bb.shape[0] // 2
    ar = np.zeros(a.shape[:-2] + (ryp, kpn), np.float32)
    ai = np.zeros_like(ar)
    ar[..., :a.shape[-2], :a.shape[-1]] = a.real
    ai[..., :a.shape[-2], :a.shape[-1]] = a.imag
    A_r, A_i = split3(ar), split3(ai)
    tr = x3(fr, A_r) + x3(neg(fi), A_i)
    ti = x3(fr, A_i) + x3(fi, A_r)
    T = split3(np.concatenate([tr, ti], -1).astype(np.float32))
    return x3(T, (Bb, Bs))[..., :ny, :nz]


def k7_tf32_direct(a, Fyi_t, Bz):
    """The same arithmetic straight from the float32 tables."""
    A_r, A_i = split3(a.real), split3(a.imag)
    fr, fi = split3(Fyi_t.real), split3(Fyi_t.imag)
    tr = split3((x3(fr, A_r) + x3(neg(fi), A_i)).astype(np.float32))
    ti = split3((x3(fr, A_i) + x3(fi, A_r)).astype(np.float32))
    return x3(tr, split3(Bz.real)) + x3(ti, split3(-Bz.imag))


TF32_SHAPES = [(16, 16, 16), (40, 36, 30), (24, 70, 20), (8, 300, 30)]


def test_tf32_round_is_cvt_rna():
    """tf32_round (the wrappers' table split) and the tests' rna round as
    cvt.rna.tf32.f32: to nearest at 10 mantissa bits, ties away from zero
    (on both signs), exact tf32 values kept, and the low 13 bits zero."""
    one_ulp = 2.0 ** -10
    x = np.array([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                  1.0 + one_ulp / 2 - 2.0 ** -23, 1.0 + 1.5 * one_ulp,
                  3.0e-3, -7.25, 0.0], np.float32)
    want = np.array([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0,
                     1.0 + 2 * one_ulp], np.float32)
    got = tk.tf32_round(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, rna(x))
    np.testing.assert_array_equal(got[:5], want)
    np.testing.assert_array_equal(got[6:], x[6:])
    assert not (got.view(np.uint32) & 0x1FFF).any()
    big, small = (v.numpy() for v in tk.tf32_split(torch.as_tensor(x)))
    np.testing.assert_array_equal(big, got)
    # 1 + 2^-11 - 2^-23 has 23 significant bits: its small part keeps 11
    assert (np.abs(big + small - x) <= np.spacing(np.abs(x))).all()
    assert big[3] + small[3] != x[3]


def fp32_tables(shape):
    _, M = k6_case(shape)
    return M, {k: torch.as_tensor(M[k]) for k in M}


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_tf32_tables_round_trip(shape):
    """The 3xTF32 tables (tf32_tables, inverse_tf32_tables) read back from
    their fragment order give the float32 tables, zero-padded: big + small
    within one float32 ulp of each entry (the split keeps 22 of its 24
    bits), big and small tf32 values (low 13 bits zero), |small| <= 2^-11
    |x|."""
    M, T = fp32_tables(shape)
    fzt, fya = tk.tf32_tables(T["Fz_t"], T["Fy_t"])
    fia, bzt = tk.inverse_tf32_tables(T["Fyi_t"], T["Bz"])
    for t in (fzt, fya, fia, bzt):
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert not (t.numpy().view(np.uint32) & 0x1FFF).any()
    kzc, nz = M["Fz_t"].shape
    ry, ny = M["Fy_t"].shape
    Bb, Bs = tf32_b_unpack(fzt.numpy())
    kc = Bb.shape[-1] // 2
    F = [tf32_a_unpack(fya.numpy()[:, :, q]) for q in range(4)]
    Fi = [tf32_a_unpack(np.swapaxes(fia.numpy()[:, :, q], 0, 1))
          for q in range(4)]
    Zb, Zs = tf32_b_unpack(bzt.numpy())
    kpn = Zb.shape[0] // 2
    fz = M["Fz_t"]
    cases = [  # (big, small, the float32 table it holds at its origin)
        (np.concatenate([Bb[c, :, :kc] for c in range(len(Bb))], 1),
         np.concatenate([Bs[c, :, :kc] for c in range(len(Bs))], 1),
         fz.real.T),
        (np.concatenate([Bb[c, :, kc:] for c in range(len(Bb))], 1),
         np.concatenate([Bs[c, :, kc:] for c in range(len(Bs))], 1),
         fz.imag.T),
        (F[0], F[1], M["Fy_t"].real), (F[2], F[3], M["Fy_t"].imag),
        (Fi[0], Fi[1], M["Fyi_t"].real), (Fi[2], Fi[3], M["Fyi_t"].imag),
        (Zb[:kpn], Zs[:kpn], M["Bz"].real),
        (Zb[kpn:], Zs[kpn:], -M["Bz"].imag)]
    for big, small, x in cases:
        r, c = x.shape
        x = x.astype(np.float32)
        np.testing.assert_array_equal(big[r:], 0)
        np.testing.assert_array_equal(big[:, c:], 0)
        big, small = big[:r, :c], small[:r, :c]
        assert (np.abs(big + small - x) <= np.spacing(np.abs(x))).all()
        assert (np.abs(small) <= 2.0 ** -11 * np.abs(x)).all()


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_k6_tf32_tables_feed_the_kernel_its_spec(shape):
    """The operands the wrapper lays out for K6's 3xTF32 kernel
    (tf32_tables: Fz's planes by chunk as B fragments, Fy's as A
    fragments), read as the kernel reads them, give the direct 3xTF32
    arithmetic on the float32 tables: <= 1e-6 of max|out| (the same tf32
    values, summed in float64 in another order). Batch 3; 24x70x20 has
    several y-tiles, a ragged last one and Kzc = 7; 8x300x30 Ry = 199, two
    row parts."""
    w, M = k6_case(shape, seed=7)
    _, T = fp32_tables(shape)
    fzt, fya = tk.tf32_tables(T["Fz_t"], T["Fy_t"])
    ry, kzc = M["Fy_t"].shape[0], M["Fz_t"].shape[0]
    got = k6_tf32_from_tables(w, fzt, fya, shape[1], ry, kzc)
    want = k6_tf32_direct(w, M["Fz_t"], M["Fy_t"])
    assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_k6_tf32_spec_is_fp32_class(shape):
    """K6's 3xTF32 arithmetic (the emulation on the wrapper's tables)
    against float64 on the same float32 tables: within 4x the error of the
    fp32 twin (zy_forward at 'highest') against float64, so the split keeps
    the HIGHEST contract."""
    w, M = k6_case(shape, seed=8)
    _, T = fp32_tables(shape)
    fzt, fya = tk.tf32_tables(T["Fz_t"], T["Fy_t"])
    ry, kzc = M["Fy_t"].shape[0], M["Fz_t"].shape[0]
    exact = M["Fy_t"].astype(np.complex128) @ (
        w.astype(np.float64) @ M["Fz_t"].astype(np.complex128).T)
    emu = rel_err(k6_tf32_from_tables(w, fzt, fya, shape[1], ry, kzc), exact)
    twin = rel_err(tk.zy_forward(torch.as_tensor(w), M["Fz_t"], M["Fy_t"],
                                 "highest").numpy(), exact)
    print(f"K6 3xTF32 {shape}: {emu:.3e} of max|out|, fp32 twin {twin:.3e}")
    assert emu <= 4 * twin


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_k7_tf32_tables_feed_the_kernel_its_spec(shape):
    """The operands the wrapper lays out for K7's 3xTF32 kernel
    (inverse_tf32_tables: Fyi's planes as A fragments by row tile, [Bz_re;
    -Bz_im] as B fragments), read as the kernel reads them, give the
    direct 3xTF32 arithmetic on the float32 tables: <= 1e-6 of max|out|.
    Three x-slabs; 24x70x20 has Ry = 47 (ragged k-steps) and Kzc = 7;
    8x300x30 three 128-row y-tiles."""
    a6, M = spectra(shape, 9, 1)
    a = a6[0, :3]
    got = k7_tf32_from_tables(a, *tk.inverse_tf32_tables(
        torch.as_tensor(M["Fyi_t"]), torch.as_tensor(M["Bz"])), *shape[1:])
    want = k7_tf32_direct(a, M["Fyi_t"], M["Bz"])
    assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_k7_tf32_spec_is_fp32_class(shape):
    """K7's 3xTF32 arithmetic against float64 on the same float32 tables:
    within 4x the error of the fp32 twin (yz_inverse at 'highest')."""
    a6, M = spectra(shape, 10, 1)
    a = a6[0, :3]
    tables = tk.inverse_tf32_tables(torch.as_tensor(M["Fyi_t"]),
                                    torch.as_tensor(M["Bz"]))
    t = M["Fyi_t"].astype(np.complex128) @ a.astype(np.complex128)
    bz = M["Bz"].astype(np.complex128)
    exact = t.real @ bz.real - t.imag @ bz.imag
    emu = rel_err(k7_tf32_from_tables(a, *tables, *shape[1:]), exact)
    twin = rel_err(tk.yz_inverse(torch.as_tensor(a), M["Fyi_t"], M["Bz"],
                                 shape[2], "highest").numpy(), exact)
    print(f"K7 3xTF32 {shape}: {emu:.3e} of max|out|, fp32 twin {twin:.3e}")
    assert emu <= 4 * twin


# --- K8 at 'high'/'highest': the 3xTF32 pair's spec --------------------------

def k8_tf32_from_tables(a6, fia, bzt, fzt, fya, ny, nz, ry, kzc):
    """K8's 3xTF32 pair step by step on the operands it is given (K7's
    tables from inverse_tf32_tables, K6's from tf32_tables), in float64
    with the kernels' splits and fp32 roundings: the spectrum split as
    loaded, t rounded to float32 and split (K7's model) for each of the six
    fields, each physical field rounded to float32 (its fp32 sums), u x
    omega in float32, then K6's model on the three products: each split
    as loaded, t1 rounded to float32 and split (S), and the y-stage."""
    phys = np.stack([k7_tf32_from_tables(f, fia, bzt, ny, nz)
                     for f in a6]).astype(np.float32)
    u1, u2, u3, w1, w2, w3 = phys
    lam = np.stack([u2 * w3 - u3 * w2, u3 * w1 - u1 * w3, u1 * w2 - u2 * w1])
    return k6_tf32_from_tables(lam, fzt, fya, ny, ry, kzc)


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_k8_tf32_spec_is_fp32_class(shape):
    """K8's 3xTF32 arithmetic (the emulation on the wrapper's tables, with
    the splits where the kernels split: the spectrum, t, the products and
    S) against the JAX fused_lamb on the same input in float64 (interpret
    mode, the complex64 tables in float64): within 4x the error of the fp32
    twin (lamb at 'highest') against it, so the split keeps the HIGHEST
    contract. Three x-slabs; 24x70x20 has Ry = 47, ny = 70, Kzc = 7 and nz
    = 20 (ragged k-steps, y-tiles and n-tiles); 8x300x30 Ry = 199, two row
    parts in the y-stage."""
    a6, M = spectra(shape, 11, 6)
    a6 = a6[:, :3]
    ny, nz = shape[1:]
    ry, kzc = M["Fy_t"].shape[0], M["Fz_t"].shape[0]
    T = {k: torch.as_tensor(M[k]) for k in ("Fyi_t", "Bz", "Fz_t", "Fy_t")}
    exact = np.asarray(jk.fused_lamb(jnp.asarray(a6.astype(np.complex128)),
                                     M["Fyi_t"], M["Bz"], M["Fz_t"],
                                     M["Fy_t"], nz, precision="highest",
                                     interpret=True))
    emu = rel_err(k8_tf32_from_tables(
        a6, *tk.inverse_tf32_tables(T["Fyi_t"], T["Bz"]),
        *tk.tf32_tables(T["Fz_t"], T["Fy_t"]), ny, nz, ry, kzc), exact)
    twin = rel_err(tk.lamb(torch.as_tensor(a6), M["Fyi_t"], M["Bz"],
                           M["Fz_t"], M["Fy_t"], nz, "highest").numpy(),
                   exact)
    print(f"K8 3xTF32 {shape}: {emu:.3e} of max|out|, fp32 twin {twin:.3e}")
    assert emu <= 4 * twin
