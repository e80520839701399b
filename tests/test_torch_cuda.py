"""The port's CUDA kernels against their plain torch twins, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. This
file imports neither jax nor the JAX package, so on a machine without jax
it runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float64 at a fixed sweep count <= 1e-10 abs (nvcc contracts to
FMA, so kernel and twin are not bitwise equal); float32 <= 1e-4 relative to
the field's max. The 3D transform kernels (float32 only) are held against
their twins at 'highest' (fp32 GEMMs, TF32 off), <= 1e-4 relative, and
their 3xTF32 kernels (at 'high' and 'highest') also against a float64
twin, within 4x the fp32 twin's own error there; the
tensor-core kernels of K6, K7 and K8 against their twins at 'default'
(bf16 operands and intermediates, fp32 sums on both sides), <= 1e-3 of
max|out|: the sums run in another order, and that can flip a rounding of
an intermediate to bf16 by one ulp. The direct solves (plain torch, cuBLAS on the card) are held against the same
solve on the CPU: float64 <= 1e-10 and float32 <= 1e-4 of the scale. The 2D
periodic solver (cuFFT, cuBLAS) likewise: each engine in float64 <= 1e-10,
diffable's gradient <= 1e-9; float32 Taylor-Green runs against the exact
decay within chip_smoke.py's bounds. Each kernel's operator
(`torch.ops.ns_tpu`) passes `torch.library.opcheck` on CUDA tensors, and
an artifact of a kernel configuration exported on the card is its eager
engine bitwise, with the same kernel launches.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from ns_tpu_torch.core.bc import apply_bcs, dirichlet, neumann
from ns_tpu_torch.ops import fast_poisson, kernels, poisson
from ns_tpu_torch.ops.kernels.poisson_kernels import _color_groups
from ns_tpu_torch.solvers import spectral3d as s3
from ns_tpu_torch.solvers import spectral_periodic as sp

pytestmark = pytest.mark.cuda

DTYPES = [(torch.float64, 1e-10), (torch.float32, 1e-4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def rand(shape, dtype, device, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=gen,
                                dtype=torch.float64)).to(device, dtype)


def close(got, want, dtype, atol):
    scale = 1.0 if dtype == torch.float64 else max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= atol * scale


def p_bcs(h):
    return [dirichlet(0, "top"), neumann(0, "bottom", h, h),
            neumann(0.5, "left", h, h), neumann(0, "right", h, h)]


def k2_bc_lists(h):
    """The BC lists K2 is held to: the cavity-like `p_bcs`, two sides only
    (two corners keep their values), a repeated side, and every side
    Dirichlet in reverse order."""
    return [p_bcs(h),
            [neumann(0.5, "left", h, h), dirichlet(1.0, "top")],
            [dirichlet(2.0, "bottom"), neumann(-1.0, "right", h, h),
             neumann(0.3, "bottom", h, h), dirichlet(-0.5, "left"),
             neumann(0.7, "top", h, h)],
            [dirichlet(v, s) for v, s in ((1.0, "top"), (2.0, "bottom"),
                                          (3.0, "right"), (4.0, "left"))]]


# K2's grids: the reference-like 50x43, 3xN edge grids (every interior cell
# next to two edges), and the largest grids one block holds (170^2 in
# float32, 120^2 in float64: 28 and 14 interior cells a thread)
K2_CASES = [(torch.float64, 1e-10, (50, 43)), (torch.float32, 1e-4, (50, 43)),
            (torch.float64, 1e-10, (3, 3)), (torch.float32, 1e-4, (3, 70)),
            (torch.float64, 1e-10, (70, 3)),
            (torch.float64, 1e-10, (120, 120)),
            (torch.float32, 1e-4, (170, 170))]


@pytest.mark.parametrize("dtype,atol,shape", K2_CASES)
def test_jacobi_fused(cuda, dtype, atol, shape):
    """K2 against its twin for each BC list, one launch a call, at nit 50
    and 0 (nothing changes, not even the corners)."""
    nx, ny = shape
    h = 2.0 / (nx - 1)
    p0, b = rand((nx, ny), dtype, cuda, 0), rand((nx, ny), dtype, cuda, 1, 10.0)
    for bcs in k2_bc_lists(h):
        n0 = kernels.jacobi_fused.launches
        got = kernels.jacobi_fused(p0, b, h, h, 50, bcs)
        assert kernels.jacobi_fused.launches == n0 + 1
        want = poisson.jacobi(p0, b, h, h, 50,
                              bc_fn=lambda q: apply_bcs(q, bcs))
        close(got, want, dtype, atol)
        assert torch.equal(kernels.jacobi_fused(p0, b, h, h, 0, bcs), p0)


# K2mb held bitwise against K2 on the grids one block holds: the same
# expression, its rounding pinned, and the same edge plan
K2MB_BITWISE = [(torch.float32, (50, 50)), (torch.float32, (120, 120)),
                (torch.float32, (170, 170)), (torch.float64, (120, 120))]


@pytest.mark.parametrize("dtype,shape", K2MB_BITWISE)
def test_jacobi_multiblock_equals_jacobi_fused(cuda, dtype, shape):
    """K2's multi-block form (one resident launch on its tile plan) gives
    K2's bits for each BC list, at nit 50, 11 (a short last group) and 0."""
    nx, ny = shape
    h = 2.0 / (nx - 1)
    p0, b = rand(shape, dtype, cuda, 0), rand(shape, dtype, cuda, 1, 10.0)
    mb = kernels.jacobi_multiblock
    for bcs in k2_bc_lists(h):
        for nit in (50, 11, 0):
            n0, r0 = mb.launches, mb.launches_resident
            got = mb(p0, b, h, h, nit, bcs)
            assert (mb.launches, mb.launches_resident) == (n0 + 1, r0 + 1)
            assert torch.equal(got, kernels.jacobi_fused(p0, b, h, h, nit,
                                                         bcs))


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(1024, 1024), (1025, 1025), (257, 190)])
def test_jacobi_multiblock(cuda, dtype, atol, shape):
    """On the resident route (one launch a solve) against the twin for
    each BC list, nit 50 and 7; nit 0 copies p."""
    h = 2.0 / (shape[0] - 1)
    p0 = rand(shape, dtype, cuda, 0)
    b = rand(shape, dtype, cuda, 1, 10.0)
    mb = kernels.jacobi_multiblock
    for bcs in k2_bc_lists(h):
        for nit in (50, 7):
            n0, r0, c0 = mb.launches, mb.launches_resident, mb.calls
            got = mb(p0, b, h, h, nit, bcs)
            assert mb.launches - n0 == mb.launches_resident - r0 == \
                mb.calls - c0 == 1
            want = poisson.jacobi(p0, b, h, h, nit,
                                  bc_fn=lambda q: apply_bcs(q, bcs))
            close(got, want, dtype, atol)
    assert torch.equal(mb(p0, b, h, h, 0, p_bcs(h)), p0)


def test_jacobi_multiblock_group_route(cuda):
    """4096^2 float32 has no resident plan: one launch per group of 8
    sweeps (nit 50: seven, the last of two sweeps), no host sync, against
    the twin."""
    n = 4096
    h = 2.0 / (n - 1)
    p0 = rand((n, n), torch.float32, cuda, 2)
    b = rand((n, n), torch.float32, cuda, 3, 10.0)
    mb = kernels.jacobi_multiblock
    mb(p0, b, h, h, 50, p_bcs(h))
    torch.cuda.synchronize()
    n0, r0 = mb.launches, mb.launches_resident
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mb(p0, b, h, h, 50, p_bcs(h))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (mb.launches - n0, mb.launches_resident - r0) == (7, 0)
    want = poisson.jacobi(p0, b, h, h, 50,
                          bc_fn=lambda q: apply_bcs(q, p_bcs(h)))
    close(got, want, torch.float32, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jacobi_resident_solve_never_syncs(cuda, dtype):
    """A 1024^2 nit=50 solve is one launch with no host synchronisation."""
    n = 1024
    h = 2.0 / (n - 1)
    p0, b = rand((n, n), dtype, cuda, 4), rand((n, n), dtype, cuda, 5, 10.0)
    mb = kernels.jacobi_multiblock
    mb(p0, b, h, h, 50, p_bcs(h))
    torch.cuda.synchronize()
    n0 = mb.launches_resident
    torch.cuda.set_sync_debug_mode("error")
    try:
        mb(p0, b, h, h, 50, p_bcs(h))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert mb.launches_resident == n0 + 1


def tables(shape):
    """The compact DFT tables and kept sizes of a (nx, ny, nz) grid."""
    nx, ny, nz = shape
    cfg = s3.Spectral3DConfig(nx=nx, ny=ny, nz=nz, transform="matmul")
    _, rows_y, kzc = s3._compact_meta(cfg)
    return s3._dft_constants_np(cfg), len(rows_y), kzc


def crand(shape, cuda, seed):
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((*shape, 2), generator=gen, dtype=torch.float64)
    return torch.view_as_complex(z).to(cuda, torch.complex64)


def close_rel(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


SHAPES_3D = [(64, 64, 64), (40, 36, 30)]


def tables64(M):
    """The complex64 tables (the kernels' operands) in complex128."""
    return {k: v.astype(np.complex64).astype(np.complex128)
            for k, v in M.items()}


def tf32_route(label, wrapper, call, twin, twin64):
    """The 3xTF32 kernel at 'high' and 'highest': one launch a call, of
    that kernel; within close_rel of the fp32 twin at the precision; and
    against the float64 twin (the same complex64 tables in float64)
    within 4x the fp32 twin's own error there. Returns the last output."""
    want64 = twin64()
    for p in ("high", "highest"):
        n0, t0 = wrapper.launches, wrapper.launches_tf32
        b0 = wrapper.launches_bf16
        got = call(p)
        torch.cuda.synchronize()
        assert (wrapper.launches - n0, wrapper.launches_tf32 - t0,
                wrapper.launches_bf16 - b0) == (1, 1, 0)
        want = twin(p)
        close_rel(got, want)
        err = rel_to_twin(got.to(want64.dtype), want64)
        ref = rel_to_twin(want.to(want64.dtype), want64)
        print(f"{label} '{p}': 3xTF32 {err:.3e} of max|out| from float64, "
              f"fp32 twin {ref:.3e}")
        assert err <= 4 * ref
    return got


@pytest.mark.parametrize("shape", SHAPES_3D)
def test_fused_zy_forward(cuda, shape):
    """K6 at its default precision ('high') and at 'highest' launches its
    3xTF32 kernel and matches its twin; fp32-class against float64."""
    M, ry, kzc = tables(shape)
    w = rand((3, *shape), torch.float32, cuda, 10)
    n0 = kernels.fused_zy_forward.launches
    got = kernels.fused_zy_forward(w, M["Fz_t"], M["Fy_t"])
    assert kernels.fused_zy_forward.launches == n0 + 1
    assert got.shape == (3, shape[0], ry, kzc)
    close_rel(got, kernels.zy_forward(w, M["Fz_t"], M["Fy_t"], "highest"))
    M64 = tables64(M)
    tf32_route(f"K6 {shape}", kernels.fused_zy_forward,
               lambda p: kernels.fused_zy_forward(w, M["Fz_t"], M["Fy_t"], p),
               lambda p: kernels.zy_forward(w, M["Fz_t"], M["Fy_t"], p),
               lambda: kernels.zy_forward(w.double(), M64["Fz_t"],
                                          M64["Fy_t"], "highest"))


@pytest.mark.parametrize("shape", [(256, 256, 256), (40, 36, 30),
                                   (8, 300, 30)])
def test_fused_zy_forward_default(cuda, shape):
    """K6 at 'default' launches its tensor-core kernel and matches its
    twin at 'default'; at 'high' and 'highest' the 3xTF32 kernel matches
    its twin and is fp32-class against float64 (256^3 B=3 is the main
    path's shape; 8x300x30 has Ry = 199, so its block-matrix rows take two
    blocks, and nz % 4 != 0)."""
    M, ry, kzc = tables(shape)
    w = rand((3, *shape), torch.float32, cuda, 13)
    n0 = kernels.fused_zy_forward.launches_bf16
    got = kernels.fused_zy_forward(w, M["Fz_t"], M["Fy_t"], "default")
    assert kernels.fused_zy_forward.launches_bf16 == n0 + 1
    assert got.shape == (3, shape[0], ry, kzc)
    want = kernels.zy_forward(w, M["Fz_t"], M["Fy_t"], "default")
    rel = float((got - want).abs().max()) / float(want.abs().max())
    print(f"K6 'default' {shape}: max_rel {rel:.3e}")
    assert rel <= 1e-3
    got = kernels.fused_zy_forward(w, M["Fz_t"], M["Fy_t"], "highest")
    assert kernels.fused_zy_forward.launches_bf16 == n0 + 1
    close_rel(got, kernels.zy_forward(w, M["Fz_t"], M["Fy_t"], "highest"))
    M64 = tables64(M)
    tf32_route(f"K6 {shape}", kernels.fused_zy_forward,
               lambda p: kernels.fused_zy_forward(w, M["Fz_t"], M["Fy_t"], p),
               lambda p: kernels.zy_forward(w, M["Fz_t"], M["Fy_t"], p),
               lambda: kernels.zy_forward(w.double(), M64["Fz_t"],
                                          M64["Fy_t"], "highest"))


def test_gemm_default_on_the_card(cuda):
    """ops/gemm.py at 'default' on the card (bf16 GEMMs with an fp32
    output): 2D @ 2D, 2D @ batched, batched @ 2D and complex, within 1e-5
    of max|out| of the float64 product of the bf16-rounded inputs, and
    against the CPU form (fp32 GEMM of the rounded inputs)."""
    from ns_tpu_torch.ops import gemm
    r = lambda x: x.to(torch.bfloat16).to(torch.float64)
    a, b = rand((171, 256), torch.float32, cuda, 20), rand((256, 86),
                                                           torch.float32,
                                                           cuda, 21)
    a3 = rand((3, 40, 256), torch.float32, cuda, 22)
    b3 = rand((2, 256, 300), torch.float32, cuda, 23)
    for x, y in ((a, b), (a, b3), (a3, b)):
        got = gemm.matmul(x, y, "default")
        assert got.dtype == torch.float32
        want = r(x) @ r(y)
        scale = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= 1e-5 * scale
        cpu = gemm.matmul(x.cpu(), y.cpu(), "default")
        assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * scale
    c = torch.complex(a3, a3.flip(0))
    got = gemm.cmatmul(c, b, "default").to(torch.complex128)
    want = torch.complex(r(c.real), r(c.imag)) @ r(b).to(torch.complex128)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape", SHAPES_3D + [(8, 300, 30),
                                               (256, 256, 256)])
def test_fused_yz_inverse(cuda, shape):
    """K7 at its default precision ('high') and at 'highest' launches its
    3xTF32 kernel and matches its twin; fp32-class against float64
    (8x300x30: three 128-row y-tiles, the last ragged; 256^3 the main
    path's grid)."""
    M, ry, kzc = tables(shape)
    a = crand((2, shape[0], ry, kzc), cuda, 11)
    n0 = kernels.fused_yz_inverse.launches
    got = kernels.fused_yz_inverse(a, M["Fyi_t"], M["Bz"], shape[2])
    assert kernels.fused_yz_inverse.launches == n0 + 1
    assert got.shape == (2, *shape) and got.dtype == torch.float32
    close_rel(got, kernels.yz_inverse(a, M["Fyi_t"], M["Bz"], shape[2],
                                      "highest"))
    M64 = tables64(M)
    nz = shape[2]
    tf32_route(f"K7 {shape}", kernels.fused_yz_inverse,
               lambda p: kernels.fused_yz_inverse(a, M["Fyi_t"], M["Bz"], nz,
                                                  p),
               lambda p: kernels.yz_inverse(a, M["Fyi_t"], M["Bz"], nz, p),
               lambda: kernels.yz_inverse(a.to(torch.complex128),
                                          M64["Fyi_t"], M64["Bz"], nz,
                                          "highest"))


@pytest.mark.parametrize("shape", SHAPES_3D + [(24, 70, 20),
                                               (256, 256, 256)])
def test_fused_lamb(cuda, shape):
    """K8 at 'high' and 'highest' launches its 3xTF32 pair (counted once a
    call) and matches its twin; fp32-class against float64 (24x70x20:
    ragged k-steps, y-tiles and n-tiles, Kzc = 7; 256^3 the main path's
    grid)."""
    M, ry, kzc = tables(shape)
    a6 = crand((6, shape[0], ry, kzc), cuda, 12)
    nz = shape[2]
    args = (a6, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"], nz)
    M64 = tables64(M)
    got = tf32_route(f"K8 {shape}", kernels.fused_lamb,
                     lambda p: kernels.fused_lamb(*args, precision=p),
                     lambda p: kernels.lamb(*args, precision=p),
                     lambda: kernels.lamb(a6.to(torch.complex128),
                                          M64["Fyi_t"], M64["Bz"],
                                          M64["Fz_t"], M64["Fy_t"], nz,
                                          "highest"))
    assert got.shape == (3, shape[0], ry, kzc)
    assert bool(torch.isfinite(got).all())


SHAPES_DEFAULT = [(256, 256, 256), (40, 36, 30), (24, 70, 20)]


def rel_to_twin(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("shape", SHAPES_DEFAULT)
def test_fused_yz_inverse_default(cuda, shape):
    """K7 at 'default' launches its tensor-core kernel and matches its twin
    at 'default' within 1e-3 of max|out| (the fp32 sums run in another
    order, which can flip a rounding of t to bf16 by one ulp); at
    'highest' the fp32 kernel matches its twin. 256^3 B=1 is the main
    path's shape (divergence_max); 24x70x20 has ragged row tiles, y-tiles
    and Kzc = 7."""
    M, ry, kzc = tables(shape)
    a = crand((1, shape[0], ry, kzc), cuda, 17)
    args = (a, M["Fyi_t"], M["Bz"], shape[2])
    n0 = kernels.fused_yz_inverse.launches_bf16
    got = kernels.fused_yz_inverse(*args, "default")
    assert kernels.fused_yz_inverse.launches_bf16 == n0 + 1
    assert got.shape == (1, *shape) and got.dtype == torch.float32
    rel = rel_to_twin(got, kernels.yz_inverse(*args, "default"))
    print(f"K7 'default' {shape}: max_rel {rel:.3e}")
    assert rel <= 1e-3
    got = kernels.fused_yz_inverse(*args, "highest")
    assert kernels.fused_yz_inverse.launches_bf16 == n0 + 1
    close_rel(got, kernels.yz_inverse(*args, "highest"))


@pytest.mark.parametrize("shape", SHAPES_DEFAULT)
def test_fused_lamb_default(cuda, shape):
    """K8 at 'default' launches its tensor-core pair and matches its twin
    at 'default' within 1e-3 of max|out|; at 'highest' the 3xTF32 pair
    matches its twin."""
    M, ry, kzc = tables(shape)
    a6 = crand((6, shape[0], ry, kzc), cuda, 18)
    args = (a6, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"], shape[2])
    n0 = kernels.fused_lamb.launches_bf16
    got = kernels.fused_lamb(*args, precision="default")
    assert kernels.fused_lamb.launches_bf16 == n0 + 1
    assert got.shape == (3, shape[0], ry, kzc)
    rel = rel_to_twin(got, kernels.lamb(*args, precision="default"))
    print(f"K8 'default' {shape}: max_rel {rel:.3e}")
    assert rel <= 1e-3
    got = kernels.fused_lamb(*args, precision="highest")
    assert kernels.fused_lamb.launches_bf16 == n0 + 1
    close_rel(got, kernels.lamb(*args, precision="highest"))


def test_gemm_high_on_the_card(cuda):
    """ops/gemm.py at 'high' on the card meets the TPU's HIGH: within 1e-5
    of max|out| of the float64 product of the fp32 inputs (TF32 reads
    ~3.5e-4 there), even with TF32 enabled globally: 2D @ 2D, batched,
    and complex."""
    from ns_tpu_torch.ops import gemm
    a = rand((256, 256), torch.float32, cuda, 24)
    b = rand((256, 172), torch.float32, cuda, 25)
    b3 = rand((2, 256, 300), torch.float32, cuda, 26)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for x, y in ((a, b), (a, b3)):
            want = x.double() @ y.double()
            got = gemm.matmul(x, y, "high")
            assert float((got.double() - want).abs().max()) <= (
                1e-5 * float(want.abs().max()))
        c = torch.complex(a, a.flip(0))
        want = c.to(torch.complex128) @ b.double().to(torch.complex128)
        got = gemm.cmatmul(c, b, "high").to(torch.complex128)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_fused_step_matches_plain_step(cuda):
    """One IF-AB2 step at 64^3, f32 'highest': the fused route (K6 at carry
    init, K8 in the step) against the plain GEMM chain."""
    kw = dict(nx=64, ny=64, nz=64, transform="matmul",
              matmul_precision="highest")
    out = {}
    for fused in (False, True):
        cfg = s3.Spectral3DConfig(use_pallas_transform=fused, **kw)
        u0 = s3.random_solenoidal_velocity(cfg, seed=1, k_peak=3.0)
        n0 = kernels.launch_counts()
        step, _ = s3.make_step(cfg, cuda)
        carry, _ = step(s3.init_from_velocity(cfg, u0, cuda))
        n1 = kernels.launch_counts()
        ran = {k for k in n1 if n1[k] > n0[k]}
        assert ran == ({"fused_zy_forward", "fused_lamb"} if fused else set())
        out[fused] = s3.fields_from_hat(cfg, carry[0])
    close_rel(out[True], out[False])


def test_fused_high_step_graph_replays_bitwise(cuda):
    """A CUDA graph of the fused 'high' step at 64^3 (K8's 3xTF32 pair, one
    call a step) replays bitwise equal to the eager step: the route makes
    no host-to-device copy and no host sync a call."""
    cfg = s3.Spectral3DConfig(nx=64, ny=64, nz=64, transform="matmul",
                              matmul_precision="high",
                              use_pallas_transform=True)
    carry = s3.init_from_velocity(cfg, s3.random_solenoidal_velocity(
        cfg, seed=2, k_peak=3.0), cuda)
    step, _ = s3.make_step(cfg, cuda)
    eager, _ = step(carry)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(carry)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = kernels.fused_lamb.launches_tf32
    with torch.cuda.graph(graph):
        replayed, _ = step(carry)
    assert kernels.fused_lamb.launches_tf32 == t0 + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(replayed, eager):
            assert torch.equal(got, want)


def test_transform_wrappers_reject_what_the_kernels_do_not_take(cuda):
    M, ry, kzc = tables((64, 64, 64))
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_zy_forward(torch.zeros((64, 64, 64), device=cuda,
                                             dtype=torch.float64),
                                 M["Fz_t"], M["Fy_t"])
    with pytest.raises(ValueError, match="fused_lamb wants"):
        kernels.fused_lamb(crand((3, 64, ry, kzc), cuda, 0), M["Fyi_t"],
                           M["Bz"], M["Fz_t"], M["Fy_t"], 64)
    # 512^3: K6's tensor-core kernel and K7's 3xTF32 kernel refuse it
    # (K6's 3xTF32 kernel needs the same shared memory at any grid)
    M5, ry5, kzc5 = tables((512, 512, 512))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_zy_forward(torch.zeros((1, 512, 512, 512), device=cuda),
                                 M5["Fz_t"], M5["Fy_t"], "default")
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_yz_inverse(crand((1, 512, ry5, kzc5), cuda, 0),
                                 M5["Fyi_t"], M5["Bz"], 512)


# K1's grids: the reference 51^2, an odd-by-even one, and the largest one
# block holds (170^2 in float32, 120^2 in float64), where rhs_c leaves the
# registers for shared memory
K1_CASES = [(torch.float64, 1e-10, (51, 51)), (torch.float32, 1e-4, (51, 51)),
            (torch.float64, 1e-10, (64, 37)), (torch.float32, 1e-4, (64, 37)),
            (torch.float64, 1e-10, (120, 120)),
            (torch.float32, 1e-4, (170, 170))]


@pytest.mark.parametrize("dtype,atol,shape", K1_CASES)
def test_sor_redblack_fused(cuda, dtype, atol, shape):
    """K1 at a fixed sweep count (tol 0, cap 200) against its twin, then
    with a converged gate (tol 5e-6: the runs may stop a sweep apart)."""
    h = 2.0 / (shape[0] - 1)
    p0, c = rand(shape, dtype, cuda, 2), rand(shape, dtype, cuda, 3, h * h)
    n0 = kernels.sor_redblack_fused.launches
    got = kernels.sor_redblack_fused(p0, c, h, h, 1.25, 0.0, 200)
    assert kernels.sor_redblack_fused.launches == n0 + 1
    close(got, poisson.sor_redblack(p0, c, h, h, 1.25, 0.0, 200), dtype, atol)
    got = kernels.sor_redblack_fused(p0, c, h, h, 1.25, 5e-6, 200)
    conv = 1e-4 if dtype == torch.float64 else 1e-3
    close(got, poisson.sor_redblack(p0, c, h, h, 1.25, 5e-6, 200), dtype,
          conv)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(256, 256), (257, 190), (257, 191),
                                   (1025, 1025)])
def test_sor_redblack_multiblock(cuda, dtype, atol, shape):
    """tol=0 and cap 8*4+1: four gated groups of k=8 sweeps, on the
    resident route (one launch a solve, odd ny included), against the twin
    and the colour-group kernels on the same input."""
    h = 2.0 / (shape[0] - 1)
    p0, c = rand(shape, dtype, cuda, 4), rand(shape, dtype, cuda, 5, h * h)
    k5 = kernels.sor_redblack_multiblock
    n0, r0 = k5.launches, k5.launches_resident
    got = k5(p0, c, h, h, 1.25, 0.0, 33)
    assert (k5.launches, k5.launches_resident) == (n0 + 1, r0 + 1)
    close(got, kernels.sor_redblack_tiled(p0, c, h, h, 1.25, 0.0, 33), dtype,
          atol)
    n0 = k5.launches
    close(got, _color_groups(p0, c, h, h, 1.25, 0.0, 33, 8), dtype, atol)
    assert k5.launches == n0 + 4


def test_sor_redblack_multiblock_beyond_shared_memory(cuda):
    """4097^2 float32 has no resident plan on the card: one launch of the
    colour-group kernels per gate group and the host gate (cap 17: two)."""
    n = 4097
    h = 2.0 / (n - 1)
    p0 = rand((n, n), torch.float32, cuda, 6)
    c = rand((n, n), torch.float32, cuda, 7, h * h)
    k5 = kernels.sor_redblack_multiblock
    n0, r0 = k5.launches, k5.launches_resident
    got = k5(p0, c, h, h, 1.25, 0.0, 17)
    assert (k5.launches, k5.launches_resident) == (n0 + 2, r0)
    close(got, kernels.sor_redblack_tiled(p0, c, h, h, 1.25, 0.0, 17),
          torch.float32, 1e-4)


# K4's grids: 1024^2 and 257x190 (off the routing predicate) take the
# resident route; 4096^2 does not fit the card's shared memory and keeps
# the group route (cap 17: two groups)
K4_CASES = [(torch.float64, 1e-10, (1024, 1024), 33),
            (torch.float32, 1e-4, (1024, 1024), 33),
            (torch.float64, 1e-10, (257, 190), 33),
            (torch.float32, 1e-4, (257, 190), 33),
            (torch.float32, 1e-4, (4096, 4096), 17)]


@pytest.mark.parametrize("dtype,atol,shape,cap", K4_CASES)
def test_sor_redblack_packed_multiblock(cuda, dtype, atol, shape, cap):
    """K4 at tol=0 against its twin and against K5's colour-group kernels
    (the same iterate sequence): one launch a solve on the resident route,
    one per gate group of k=8 sweeps on the group route."""
    h = 2.0 / (shape[0] - 1)
    p0, c = rand(shape, dtype, cuda, 14), rand(shape, dtype, cuda, 15, h * h)
    k4 = kernels.sor_redblack_packed_multiblock
    resident = shape != (4096, 4096)
    n0, r0 = k4.launches, k4.launches_resident
    got = k4(p0, c, h, h, 1.25, 0.0, cap)
    groups = (cap - 1) // 8
    assert k4.launches == n0 + (1 if resident else groups)
    assert k4.launches_resident == r0 + resident
    close(got, kernels.sor_redblack_packed_tiled(p0, c, h, h, 1.25, 0.0, cap),
          dtype, atol)
    close(got, _color_groups(p0, c, h, h, 1.25, 0.0, cap, 8), dtype, atol)


def solve_without_sync(wrapper, p0, c, h):
    """A gated solve (nit=200, tol 5e-6) under sync debug mode "error": it
    raises if the solve synchronises with the host. Returns the result and
    the launches it made."""
    wrapper(p0, c, h, h, 1.25, 5e-6, 200)  # the first call builds the library
    torch.cuda.synchronize()
    n0 = wrapper.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = wrapper(p0, c, h, h, 1.25, 5e-6, 200)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return got, wrapper.launches - n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_resident_solve_never_syncs(cuda, dtype):
    """A gated K4 solve at 1024^2 (nit=200, tol 5e-6) is one launch with
    no host synchronisation; it stops where its twin stops."""
    n = 1024
    h = 2.0 / (n - 1)
    p0, c = rand((n, n), dtype, cuda, 16), rand((n, n), dtype, cuda, 17, h * h)
    got, launches = solve_without_sync(kernels.sor_redblack_packed_multiblock,
                                       p0, c, h)
    assert launches == 1
    close(got, kernels.sor_redblack_packed_tiled(p0, c, h, h, 1.25, 5e-6, 200),
          dtype, 1e-4 if dtype == torch.float64 else 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_k5_solve_never_syncs(cuda, dtype):
    """A gated K5 solve at 1025^2, chorin_fd's odd grid, is one launch with
    no host synchronisation; it stops where its twin stops."""
    n = 1025
    h = 2.0 / (n - 1)
    p0, c = rand((n, n), dtype, cuda, 18), rand((n, n), dtype, cuda, 19, h * h)
    got, launches = solve_without_sync(kernels.sor_redblack_multiblock, p0, c,
                                       h)
    assert launches == 1
    close(got, kernels.sor_redblack_tiled(p0, c, h, h, 1.25, 5e-6, 200),
          dtype, 1e-4 if dtype == torch.float64 else 1e-3)


def _counted(wrapper, *args):
    """The (sweeps, member-solves) one call of `wrapper` counts."""
    kernels.reset_launch_counts()
    wrapper(*args)
    return kernels.sweep_counts()[wrapper.__name__]


def _gate_tol(p, c, h, g, k=8):
    """A tol halfway (in log) between the errors that gate g and gate g - 1
    read (the red-black sweeps on the card, a gate every k sweeps)."""
    masks = poisson.checkerboard(*p.shape, device=p.device)
    errs = []
    for _ in range(k * g):
        q = poisson.redblack_sweep(p, c, h, h, 1.25, masks)
        errs.append(float((q - p).abs().max()))
        p = q
    return (errs[k * g - 1] * errs[k * (g - 1) - 1]) ** 0.5


@pytest.mark.parametrize("which", ["K1", "K4", "K5"])
def test_sweep_counts_match_the_twins(cuda, which):
    """The sweeps and member-solves that K1 (B = 8, members stopping at
    their own sweeps, one at the cap), K4 (1024^2) and K5 (1025^2) count on
    the card equal their twins' on the same float64 inputs, in an eager
    call and in one replay of a CUDA graph of the call."""
    dt = torch.float64
    if which == "K1":
        n, fn = 51, kernels.sor_redblack_fused
        h = 2.0 / (n - 1)
        scales = torch.logspace(-5, -3, 8, dtype=dt)[:, None, None]
        p0 = torch.zeros((8, n, n), dtype=dt, device=cuda)
        c = rand((8, n, n), dt, "cpu", 20, h * h).mul(scales).to(cuda)
        args = (h, h, 1.25, 5e-6, 200)
        swept = poisson.sor_redblack_counted(p0.cpu(), c.cpu(), *args)[1]
        assert len(set(swept.tolist())) >= 4 and int(swept.max()) == 199
    else:
        n = 1024 if which == "K4" else 1025
        fn = (kernels.sor_redblack_packed_multiblock if which == "K4"
              else kernels.sor_redblack_multiblock)
        h = 2.0 / (n - 1)
        p0, c = rand((n, n), dt, cuda, 21), rand((n, n), dt, cuda, 22, h * h)
        args = (h, h, 1.25, _gate_tol(p0, c, h, 10), 200)
    want = _counted(fn, p0.cpu(), c.cpu(), *args)
    if which != "K1":
        assert want == (80, 1)
    assert _counted(fn, p0, c, *args) == want
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(p0, c, *args)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(p0, c, *args)
    kernels.reset_launch_counts()
    graph.replay()
    torch.cuda.synchronize()
    assert kernels.sweep_counts()[fn.__name__] == want


def test_profile_run_on_the_card(cuda):
    """profile_run's idle share is 1 - the union of the profiled rollout's
    device records over its range, and it reports K1's sweeps a solve."""
    from ns_tpu_torch.cli import profile_run

    r = profile_run.profile(["chorin_fd", "--method", "explicit", "--nt",
                             "10"])
    assert 0.0 <= r["device_idle_share"] < 1.0
    assert r["device_busy_ms"] <= r["profiled_range_ms"]
    assert 1 <= r["sor_sweeps_per_solve"]["sor_redblack_fused"] <= 199


def test_packed_wrapper_rejects_odd_ny(cuda):
    odd = torch.zeros((256, 255), device=cuda)
    with pytest.raises(ValueError, match="even ny"):
        kernels.sor_redblack_packed_multiblock(odd, odd, 0.01, 0.01, 1.25,
                                               0.0, 9)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_direct_solves_on_the_card_match_cpu(cuda, dtype, atol):
    """A dst Poisson solve (parity-split engine at 258^2) and a mixed-BC
    solve on the card against the same solves on the CPU."""
    n = 258
    h = 2.0 / (n - 1)
    p0, f = rand((n, n), dtype, cuda, 16), rand((n, n), dtype, cuda, 17)
    for dev, (pp, ff) in (("cuda", (p0, f)), ("cpu", (p0.cpu(), f.cpu()))):
        solve = fast_poisson.make_dst_poisson(n, n, h, h, dtype=dtype,
                                              device=dev)
        out = solve(pp, ff)
        if dev == "cuda":
            got = out.cpu()
        else:
            close(got, out, dtype, atol)
    bcs = p_bcs(h)
    mixed = fast_poisson.make_mixed_poisson(n, n, h, h, bcs)
    close(mixed(f).cpu(), mixed(f.cpu()), dtype, atol)


def momentum_bc_lists(h):
    """The cavity's u and v lists, and lists with Neumann sides."""
    cav_u = [dirichlet(0, "left"), dirichlet(1, "right"), dirichlet(0, "top"),
             dirichlet(0, "bottom")]
    cav_v = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    neu_u = [neumann(0.5, "left", h, h), dirichlet(1, "right"),
             neumann(-0.25, "top", h, h), dirichlet(0, "bottom")]
    neu_v = [neumann(0, "bottom", h, h), dirichlet(0, "top"),
             dirichlet(0, "left"), neumann(-1.0, "right", h, h)]
    return [(cav_u, cav_v), (neu_u, neu_v)]


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("shape", [(3, 3), (64, 37), (51, 51), (1024, 1024),
                                   (1025, 1025), (67, 130)])
def test_momentum_explicit_fused(cuda, dtype, atol, quirk, shape):
    """K3 against its twin, one launch a call, with the cavity lists and
    lists with Neumann sides (16-byte vectors at 1024^2 and 64x37 float64
    / 67x130 float64; one element a copy at the odd widths). Square grids
    have 2dx == 2dy, where the quirk's y-derivative is the x-derivative's
    quotient; the others have their own spacings."""
    nx, ny = shape
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    f = [rand(shape, dtype, cuda, 6 + i) for i in range(4)]
    for u_bc, v_bc in momentum_bc_lists(dx):
        args = (*f, 1e-3, dx, dy, 0.1, u_bc, v_bc, quirk)
        n0 = kernels.momentum_explicit_fused.launches
        got = kernels.momentum_explicit_fused(*args)
        assert kernels.momentum_explicit_fused.launches == n0 + 1
        for g, w in zip(got, kernels.momentum_explicit(*args)):
            close(g, w, dtype, atol)


@pytest.mark.parametrize("shape", [(51, 51), (1024, 1024)])
def test_momentum_explicit_fused_is_one_cuda_launch(cuda, shape):
    """The profiler sees one CUDA kernel a call (two before: the interior,
    then the BC edges)."""
    nx, ny = shape
    h = 2.0 / (nx - 1)
    f = [rand(shape, torch.float32, cuda, 10 + i) for i in range(4)]
    u_bc, v_bc = momentum_bc_lists(h)[1]
    call = lambda: kernels.momentum_explicit_fused(  # noqa: E731
        *f, 1e-3, h, h, 0.1, u_bc, v_bc, True)
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3 and all("momentum" in n for n in names), names


@pytest.mark.parametrize("which", ["K1", "K2", "K3"])
def test_batched_kernel_is_one_cuda_launch(cuda, which):
    """The profiler sees no more than one CUDA kernel a batched call, and
    no other kernel (B = 64 at the reference sizes; K1's batch as
    `sor_batch` makes it, below); the launch counters show one a call.
    Four calls in one window give 3 or 4 records: on the H100 a window's
    first launch of a hand-written kernel can be missing from its records
    (seen for K1 here), and late in this file whole windows came back
    without a device record, so the test sits early."""
    B = 64
    if which == "K1":
        p, c, h = sor_batch(51, torch.float32, cuda, B)
        call = lambda: kernels.sor_redblack_fused(  # noqa: E731
            p, c, h, h, 1.25, 5e-6, 200)
        tag = "sor_redblack_fused"
    elif which == "K2":
        h = 2.0 / 49
        p = rand((B, 50, 50), torch.float32, cuda, 46)
        b = rand((B, 50, 50), torch.float32, cuda, 47, 10.0)
        call = lambda: kernels.jacobi_fused(  # noqa: E731
            p, b, h, h, 50, p_bcs(h))
        tag = "jacobi_fused"
    else:
        h = 2.0 / 50
        f = [rand((B, 51, 51), torch.float32, cuda, 48 + i)
             for i in range(4)]
        u_bc, v_bc = momentum_bc_lists(h)[0]
        call = lambda: kernels.momentum_explicit_fused(  # noqa: E731
            *f, 1e-3, h, h, 0.1, u_bc, v_bc, True)
        tag = "momentum"
    call()
    torch.cuda.synchronize()
    wrapper = {"K1": kernels.sor_redblack_fused, "K2": kernels.jacobi_fused,
               "K3": kernels.momentum_explicit_fused}[which]
    n0 = wrapper.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert wrapper.launches == n0 + 4
    assert len(names) in (3, 4) and all(tag in n for n in names), names


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    big = torch.zeros((200, 200), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.jacobi_fused(big, big, 0.01, 0.01, 5, [])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sor_redblack_fused(big.T, big.T, 0.01, 0.01, 1.25, 0.0, 5)
    with pytest.raises(TypeError, match="float32"):
        half = big.half()
        kernels.sor_redblack_multiblock(half, half, 0.01, 0.01, 1.25, 0.0, 5)


# --- the 2D periodic solver (spectral_periodic) and diffable on the card ---

SP_ENGINES = {
    "fft": dict(transform="fft"),
    "matmul": dict(transform="matmul"),
    "matmul_nodealias": dict(transform="matmul", dealias=False),
    "compact": dict(transform="matmul", compact_spectrum=True),
    "real_gemm": dict(transform="matmul", compact_spectrum=True,
                      real_gemm=True),
}
# the float32 1024^2 Taylor-Green run against exp(-2 nu t), as chip_smoke.py's
# phase 5 (TG2D_BOUND there)
TG2D_BOUND = {"default": 1e-2, "high": 2e-6}
# bench.py's engine at 'default', card against CPU after 20 steps of 1024^2
# decaying turbulence, per part of the carry, as chip_smoke.py's phase 5
# (DEFAULT_CARD_VS_CPU_2D there)
DEFAULT_CARD_VS_CPU_2D = {"w_hat": 1e-4, "N_prev": 2e-3}


@pytest.mark.parametrize("name", list(SP_ENGINES))
def test_periodic_engines_card_vs_cpu_f64(cuda, name):
    """Each engine, 5 forced steps at 64x48 in float64 on the card against
    the CPU (cuFFT and cuBLAS sum in another order), <= 1e-10 of the
    scale."""
    cfg = sp.SpectralPeriodicConfig(nt=5, nx=64, ny=48, dt=2e-3, nu=1e-2,
                                    dtype="float64", forcing="kolmogorov",
                                    forcing_k=2, **SP_ENGINES[name])
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=2, k_peak=6.0)
    fins = [sp.carry_to_numpy(sp.rollout_final(
        cfg, sp.init_from_vorticity(cfg, w0, dev))) for dev in (cuda, "cpu")]
    for a, b in zip(*fins):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("prec", list(TG2D_BOUND))
def test_periodic_taylor_green_1024_f32(cuda, prec):
    """Compact matmul-DFT, 100 steps at 1024^2 in float32, against the
    exact decay exp(-2 nu t) of the Taylor-Green vorticity."""
    kw = dict(nt=100, nx=1024, ny=1024, dt=1e-3, nu=0.1, transform="matmul",
              compact_spectrum=True, matmul_precision=prec)
    cfg = sp.SpectralPeriodicConfig(**kw)
    w0 = sp.taylor_green_vorticity(cfg)
    sys_ = sp.NavierStokesSystem(w0, device=cuda, **kw)
    w = sp.physical_from_carry(cfg, sys_.final_state()[0]).cpu().numpy()
    exact = w0.astype(np.float64) * np.exp(-2.0 * 0.1 * 0.1)
    assert np.abs(w - exact).max() / np.abs(w0).max() <= TG2D_BOUND[prec]


def test_periodic_default_card_vs_cpu_1024(cuda):
    """bench.py's engine (compact, 'default') on a flow whose nonlinear
    term is not zero: the card's batched bf16 GEMMs against the CPU's fp32
    sums of the same bf16-rounded inputs."""
    kw = dict(nt=20, nx=1024, ny=1024, dt=5e-4, nu=1e-4, transform="matmul",
              compact_spectrum=True, matmul_precision="default")
    cfg = sp.SpectralPeriodicConfig(**kw)
    w0 = sp.decaying_turbulence_vorticity(cfg)
    fins = [sp.carry_to_numpy(sp.NavierStokesSystem(
        w0, device=dev, **kw).final_state()) for dev in (cuda, "cpu")]
    for bound, a, b in zip(DEFAULT_CARD_VS_CPU_2D.values(), *fins):
        assert np.abs(a - b).max() <= bound * np.abs(b).max()


def test_periodic_cli_on_the_card(cuda, tmp_path):
    from ns_tpu_torch.cli import run_solver
    for argv, shape in ((["taylor_green", "--nx", "128", "--nt", "5"],
                         (5, 128, 128)),
                        (["decaying_turbulence", "--nx", "128", "--nt", "3",
                          "--n-traj", "2", "--compact", "--precision",
                          "default"], (2, 3, 128, 128))):
        out = tmp_path / "o.npz"
        summary = run_solver.main(argv + ["--out", str(out)])
        assert summary["device"] == "cuda"
        d = np.load(out)
        for key in "uvp":
            assert d[key].shape == shape and np.isfinite(d[key]).all()


def test_diffable_gradient_card_vs_cpu(cuda):
    """The gradient of a rollout's loss with respect to its initial
    vorticity (8 steps, 32^2, float64) on the card against the CPU,
    <= 1e-9 relative."""
    from ns_tpu_torch.solvers import diffable
    cfg = sp.SpectralPeriodicConfig(nt=8, nx=32, ny=32, dt=5e-3, nu=1e-2,
                                    dtype="float64")
    target = sp.taylor_green_vorticity(cfg)
    w0 = np.random.default_rng(0).normal(size=(32, 32)) * 0.1
    grads = []
    for dev in (cuda, "cpu"):
        ops = sp.make_ops(cfg, dev)
        transforms = sp.make_transforms(cfg, dev)
        step_pair, _ = sp.make_step(cfg, dev)
        w = torch.tensor(w0, device=dev, requires_grad=True)
        h = torch.fft.rfft2(w)
        carry = (h, sp.nonlinear_term(h, ops, cfg, transforms))
        fin = diffable.rollout_chunked_remat(lambda c: step_pair(c)[0],
                                             carry, 8, 4)
        loss = torch.mean((torch.fft.irfft2(fin[0], s=(32, 32))
                           - torch.as_tensor(target, device=dev)) ** 2)
        grads.append(torch.autograd.grad(loss, w)[0].cpu().numpy())
    assert np.abs(grads[0] - grads[1]).max() <= 1e-9 * np.abs(grads[1]).max()


def test_compact_step_never_syncs(cuda):
    """bench.py's compact 'default' step, and its real_gemm and fft
    counterparts, enqueue without a host synchronisation."""
    for kw in (dict(transform="matmul", compact_spectrum=True),
               dict(transform="matmul", compact_spectrum=True,
                    real_gemm=True), dict(transform="fft")):
        cfg = sp.SpectralPeriodicConfig(nx=256, ny=256,
                                        matmul_precision="default", **kw)
        step, _ = sp.make_step(cfg, cuda)
        carry = sp.init_from_vorticity(
            cfg, sp.decaying_turbulence_vorticity(cfg), cuda)
        carry = step(carry)[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                carry = step(carry)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(torch.view_as_real(
            sp._to_full(cfg, carry[0]))).all())


# --- chorin_spectral (no kernel: cuBLAS GEMMs and torch elementwise ops) -----

def _cheb_cavity(n):
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    return cavity_bcs(2.0 / (n - 1), 2.0 / (n - 1))[:2]


@pytest.mark.parametrize("engine", ["dense", "composed", "quadrant"])
def test_chorin_spectral_corrected_card_vs_cpu_256(cuda, engine):
    """The corrected engines in float64 at 256^2, 10 steps: the card
    against the CPU <= 1e-10 of each field's max."""
    from ns_tpu_torch.solvers import chorin_spectral as cs

    n = 256
    bcs = _cheb_cavity(n)
    cfg = cs.ChorinSpectralConfig(
        nt=10, nx=n, ny=n, dt=1e-4, nu=0.1, quirk_compat=False,
        deflate_pressure_nullspace=True, parity_split=engine != "dense",
        parity_eig_form="quadrant" if engine == "quadrant" else None)
    z = np.zeros((n, n))
    runs = [cs.simulate(cfg, cs.init_state(cfg, z, z, z, *bcs, device=dev),
                        cs.make_step(cfg, *bcs, device=dev))
            for dev in (cuda, "cpu")]
    for a, b in zip(*runs):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-10


def test_chorin_spectral_cached_step_bitwise_on_card_1024(cuda):
    """The AB-derivative cache gives the plain step's bits on cuBLAS too
    (float32, 1024^2, the parity engine, 5 steps)."""
    from ns_tpu_torch.solvers import chorin_spectral as cs

    n = 1024
    bcs = _cheb_cavity(n)
    cfg = cs.ChorinSpectralConfig(nt=5, nx=n, ny=n, dt=1e-6, nu=0.1,
                                  quirk_compat=False,
                                  deflate_pressure_nullspace=True)
    step = cs.make_step(cfg, *bcs, dtype=torch.float32, device=cuda)
    assert step.parity_split is True
    z = np.zeros((n, n))
    s0 = cs.init_state(cfg, z, z, z, *bcs, dtype=torch.float32, device=cuda)
    plain, cached = s0, (s0, step.seed(s0))
    for _ in range(5):
        plain, cached = step(plain), step.cached(*cached)
    for k in ("u", "v", "p", "u_prev", "v_prev"):
        assert torch.equal(getattr(plain, k), getattr(cached[0], k)), k


def test_chorin_spectral_guard_trips_on_card_as_on_cpu(cuda):
    """The reference preset (51^2, float32 on the card, float64 on the
    CPU) under the guard: the same first bad step, frozen frames, and no
    host read inside the rollout."""
    from ns_tpu_torch.solvers import chorin_spectral as cs
    from ns_tpu_torch.utils.guard import guarded_rollout

    bcs = _cheb_cavity(51)
    z = np.zeros((51, 51))
    got = {}
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        sys_ = cs.NavierStokesSystem(z, z, z, *bcs, nt=20, nx=51, ny=51,
                                     nu=0.1, dtype=dtype, device=dev)
        if dev == cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            final, states = guarded_rollout(sys_._step, sys_.state0, 20)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got[str(dev)] = (bool(final.bad), int(final.first_bad_step))
        k = got[str(dev)][1]
        frozen = states.u[k - 1] if k > 0 else sys_.state0.u
        assert all(torch.equal(f, frozen) for f in states.u[k:])
    assert got["cuda"] == got["cpu"] and got["cpu"][0]


# --- the 2D surrogates (cuBLAS, cuFFT; no kernel of the library) ------------

FNO_ENGINE_CASES = [(2, 4, 16, 16, 5, 0.1), (2, 4, 17, 15, 5, 0.1),
                    (2, 4, 16, 18, 8, 0.1), (2, 4, 16, 16, 9, 0.1),
                    (2, 4, 32, 32, 16, 0.1), (8, 64, 128, 128, 43, 1 / 64)]


@pytest.mark.parametrize("b,c,nx,ny,modes,scale", FNO_ENGINE_CASES)
def test_fno_engines_agree_on_card(cuda, b, c, nx, ny, modes, scale):
    """The fft engine against the matmul engine with random complex
    weights, whose mixed spectrum is not Hermitian (cuFFT's 2D C2R assumes
    it is; the port's irfft2 does not), float32, at the JAX test's bound
    (rtol 2e-4, atol 1e-5): the JAX test's shapes and the served fno_w's
    (B=8, width 64, 128^2, modes 43, weights N(0, 1)/width)."""
    from ns_tpu_torch.models.fno import (SpectralWeights, _spectral_conv_fft,
                                         _spectral_conv_matmul)

    gen = torch.Generator().manual_seed(0)
    mx, my = min(modes, nx // 2), min(modes, ny // 2 + 1)
    s = SpectralWeights(c, c, mx, my, scale, generator=gen)
    W = s.mixing_table(torch.float32).detach().to(cuda)
    x = torch.randn(b, c, nx, ny, generator=gen).to(cuda)
    torch.testing.assert_close(_spectral_conv_fft(W, x, mx, my),
                               _spectral_conv_matmul(W, x, mx, my),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("model", ["fno", "fno_w", "fno_psi", "basis_ode",
                                   "rnn"])
@pytest.mark.parametrize("transform", ["fft", "matmul"])
def test_surrogate_card_vs_cpu_f64(cuda, model, transform):
    """A model's rollout in float64 on the card against the CPU from the
    same parameters (spectral weights at scale 1), <= 1e-10 of its max."""
    from ns_tpu_torch.models.vorticity import uvp_from_w
    from ns_tpu_torch.train.trainer import (TrainConfig, build_model,
                                            rollout_post)

    n = 32
    cfg = TrainConfig(model=model, n_coeffs=3, hidden_dim=32, fno_width=8,
                      fno_modes=11, fno_transform=transform)
    torch.manual_seed(1)
    cpu = build_model(cfg, n, n).double()
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.startswith("spectral."):
                p.mul_(64.0)
    card = build_model(cfg, n, n).double().to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 3, n, n, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)

    def run(m, x):
        if model == "rnn":
            return m.extrapolate(x.reshape(2, -1), 4)
        if model == "basis_ode":
            return m(x, 5)
        if model == "fno_w":
            xs = m.rollout(x[:, :1], 3, post=rollout_post(cfg))
            return torch.stack(uvp_from_w(xs[:, :, 0]), dim=2)
        return m.rollout(x, 3, post=rollout_post(cfg))

    with torch.inference_mode():
        want, got = run(cpu, x), run(card, x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


def test_fno_w_served_on_card_matches_cpu(cuda, tmp_path):
    """A fno_w checkpoint (64^2, width 16, full band) served on the card:
    float32 replies within 1e-4 of max|u| of the CPU's over 8 steps at
    B = 2, finite, chunked equal to unchunked, spectral divergence <= 1e-5
    of max|u|."""
    import dataclasses

    from ns_tpu_torch.serve import InferenceEngine
    from ns_tpu_torch.train.checkpoint import params_to_jax, save_checkpoint
    from ns_tpu_torch.train.trainer import TrainConfig, build_model

    n = 64
    cfg = TrainConfig(model="fno_w", fno_width=16, fno_modes=22)
    torch.manual_seed(3)
    save_checkpoint({"params": params_to_jax(build_model(cfg, n, n)),
                     "opt_state": {}}, str(tmp_path),
                    meta={"config": dataclasses.asdict(cfg), "grid": [n, n]})
    cfg_sp = sp.SpectralPeriodicConfig(nx=n, ny=n)
    frames = []
    for seed in (0, 1):
        w_hat = torch.fft.rfft2(torch.as_tensor(
            sp.decaying_turbulence_vorticity(cfg_sp, seed=seed,
                                             k_peak=n / 12)))
        u, v, _ = sp.fields_from_hat(cfg_sp, w_hat)
        frames.append(torch.stack([u, v, sp.pressure_from_hat(cfg_sp,
                                                              w_hat)]))
    x = torch.stack(frames).numpy().astype(np.float32)
    card = InferenceEngine.from_checkpoint(str(tmp_path), chunk=3)
    cpu = InferenceEngine.from_checkpoint(str(tmp_path), device="cpu")
    got, want = card.predict(x, 8), cpu.predict(x, 8)
    assert np.isfinite(got).all()
    umax = np.abs(want[:, :, 0]).max()
    assert np.abs(got - want).max() <= 1e-4 * umax
    whole = InferenceEngine.from_checkpoint(str(tmp_path), chunk=64)
    np.testing.assert_array_equal(whole.predict(x, 8), got)
    u, v = (torch.as_tensor(got[:, :, i], dtype=torch.float64) for i in (0, 1))
    kx = torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64)[:, None]
    ky = torch.fft.rfftfreq(n, 1.0 / n, dtype=torch.float64)
    div = sp.irfft2(sp._ik_mul(kx, torch.fft.rfft2(u))
                    + sp._ik_mul(ky, torch.fft.rfft2(v)), (n, n))
    assert float(div.abs().max()) <= 1e-5 * float(u.abs().max())


# --- training on the card ----------------------------------------------------
# chip_smoke.py's configuration and bounds: the float32 gradient at
# precision None within 2e-5 of max|grad| of the float64 one (fp32 sums;
# TF32's 10-bit operands miss it, in the backward alone as in every
# product); the 'default' gradient within 8e-5 (relative L2) of a float64
# emulation of its GEMMs (bf16-rounded operands and cotangents, products
# in float64), which a backward that rounds nothing misses; resume
# bitwise.


def _fno_w_grads(cuda, precision, dtype, n=64, width=32, modes=21):
    from ns_tpu_torch.train.metrics import l2_loss
    from ns_tpu_torch.train.trainer import (TrainConfig, build_forward,
                                            build_model, training_tensors)

    cfg = TrainConfig(model="fno_w", fno_width=width, fno_modes=modes,
                      fno_precision=precision)
    gen = torch.Generator().manual_seed(2)
    model = build_model(cfg, n, n, dtype=torch.float64,
                        generator=gen).to(cuda, dtype)
    obs = torch.randn(9, 1, 3, n, n, generator=gen,
                      dtype=torch.float64).to(cuda, dtype)
    frames, _ = training_tensors(cfg, obs)
    loss = l2_loss(*build_forward(cfg, frames)(model))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {name: g.double().cpu() for (name, _), g in zip(named, grads)}


def _grad_err(got, want):
    scale = max(float(g.abs().max()) for g in want.values())
    return max(float((got[k] - want[k]).abs().max()) for k in want) / scale


def _grad_err_l2(got, want):
    sq = lambda t: float((t ** 2).sum())  # noqa: E731
    return (sum(sq(got[k] - want[k]) for k in want)
            / sum(map(sq, want.values()))) ** 0.5


def test_float32_gradient_keeps_tf32_off(cuda, monkeypatch):
    """The backward products follow the forward's rule even when the
    caller turned TF32 on; the plain matmul (its backward outside the
    forward's switch) fails the bound, and so does the rule taken out."""
    from ns_tpu_torch.ops import gemm

    want = _fno_w_grads(cuda, None, torch.float64)
    assert _grad_err(_fno_w_grads(cuda, None, torch.float32), want) <= 2e-5
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert _grad_err(_fno_w_grads(cuda, None, torch.float32), want) <= 2e-5
    monkeypatch.setattr(gemm, "_apply", lambda product, a, b: product(a, b))
    assert _grad_err(_fno_w_grads(cuda, None, torch.float32), want) > 2e-5
    monkeypatch.setattr(gemm, "_no_tf32", contextlib.nullcontext)
    assert _grad_err(_fno_w_grads(cuda, None, torch.float32), want) > 2e-5


def test_default_precision_trains_on_the_card(cuda, monkeypatch):
    """A 'default' objective runs its backward on the card (bf16 tensor
    cores, fp32 sums) and stays near a float64 emulation of its GEMMs,
    where a backward of unrounded fp32 products does not."""
    from ns_tpu_torch.models import fno
    from ns_tpu_torch.ops import gemm

    got = _fno_w_grads(cuda, "default", torch.float32)

    class Fp32Backward(gemm._Product):
        @staticmethod
        def forward(ctx, a, b, forward_product):
            ctx.save_for_backward(a, b)
            ctx.product = gemm._fp32_product
            return forward_product(a, b)

    with monkeypatch.context() as m:
        m.setattr(gemm, "_Product", Fp32Backward)
        control = _fno_w_grads(cuda, "default", torch.float32)
    plain = gemm.matmul

    def emulated(a, b, precision):
        if precision == "default" and a.dtype == torch.float64 \
                and not (a.is_complex() or b.is_complex()):
            r = lambda t: t.to(torch.bfloat16).to(torch.float64)  # noqa: E731
            return gemm._apply(lambda x, y: r(x) @ r(y), a, b)
        return plain(a, b, precision)

    monkeypatch.setattr(gemm, "matmul", emulated)
    monkeypatch.setattr(fno, "matmul", emulated)
    want = _fno_w_grads(cuda, "default", torch.float64)
    assert all(torch.isfinite(g).all() for g in got.values())
    assert _grad_err_l2(got, want) <= 8e-5 < _grad_err_l2(control, want)


def test_training_resumes_bitwise_on_the_card(cuda, tmp_path):
    """2 iterations and a resume of 2 equal 4, with input noise and
    minibatch sampling from the card's generator."""
    from ns_tpu_torch.train.trainer import TrainConfig, Trainer

    n, nt = 32, 8
    cfg_sp = sp.SpectralPeriodicConfig(nx=n, ny=n, dt=5e-3, nu=1e-3)
    w0 = sp.decaying_turbulence_vorticity(cfg_sp, seed=0, k_peak=4)
    u, v, p = sp.simulate_strided(cfg_sp, w0, nt, stride=4, device=cuda)
    npz = str(tmp_path / "d.npz")
    np.savez(npz, u=u.cpu().numpy(), v=v.cpu().numpy(), p=p.cpu().numpy())
    base = dict(model="fno_w", npz_path=npz, fno_width=8, fno_modes=8,
                n_frames=nt, ckpt_every=2, input_noise=0.05, batch_size=3,
                fno_rollout_steps=2, lr_schedule="cosine", warmup_iters=1,
                grad_clip=1.0)
    whole = Trainer(TrainConfig(out_dir=str(tmp_path / "w"), n_iters=4,
                                **base))
    losses = whole.train(progress=False)
    Trainer(TrainConfig(out_dir=str(tmp_path / "h"), n_iters=2, **base)
            ).train(progress=False)
    half = Trainer(TrainConfig(out_dir=str(tmp_path / "h"), n_iters=4,
                               resume=str(tmp_path / "h" / "checkpoint.npz"),
                               **base))
    assert half.train(progress=False) == losses
    for k, p in whole.params.items():
        assert torch.equal(p, half.params[k]), k
    assert np.isfinite(losses).all()


# --- the 3D surrogates (cuBLAS, cuFFT; no kernel of the library) ------------
# chip_smoke.py's bounds: float64 card against CPU <= 1e-10 of the max;
# float32 fft against matmul at rtol 2e-4, atol 1e-5; float32 replies
# within 1e-4 of max|u| of the CPU's, their spectral divergence <= 1e-5 of
# max|u|.


def _fno3d_pair(cuda, model, transform, n):
    from ns_tpu_torch.train.trainer import TrainConfig, build_model

    cfg = TrainConfig(model=model, fno_width=6, fno_modes=4,
                      fno_transform=transform, fno_project=True,
                      fno_rollout_steps=2)
    cpu = build_model(cfg, n, n, n, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    with torch.no_grad():  # spectral weights at scale 1
        for name, p in cpu.named_parameters():
            if name.startswith("spectral."):
                p.mul_(36.0)
    card = build_model(cfg, n, n, n, dtype=torch.float64,
                       device="meta").to_empty(device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


def _objective(cfg, model, obs):
    from ns_tpu_torch.train.metrics import l2_loss
    from ns_tpu_torch.train.trainer import build_forward, training_tensors

    frames, _ = training_tensors(cfg, obs)
    loss = l2_loss(*build_forward(cfg, frames)(model))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss), {n: g.double().cpu() for (n, _), g in
                         zip(named, grads)}


@pytest.mark.parametrize("model", ["fno3d", "fno3d_w", "fno3d_a"])
@pytest.mark.parametrize("transform", ["fft", "matmul"])
def test_fno3d_families_card_vs_cpu_f64(cuda, model, transform):
    """A 3-step rollout with its filter and recovery, and the 2-step
    objective with its gradient, in float64 on the card against the CPU
    from the same parameters, <= 1e-10 of the max."""
    from ns_tpu_torch.train.trainer import (rollout_post, state_of_fields,
                                            uvp_of_state)

    n = 12
    cfg, cpu, card = _fno3d_pair(cuda, model, transform, n)
    obs = torch.randn(6, 1, 4, n, n, n, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(2))
    post = rollout_post(cfg)

    def run(m, x):
        return uvp_of_state(cfg, m.rollout(state_of_fields(cfg, x), 3,
                                           post=post))

    with torch.inference_mode():
        want, got = run(cpu, obs[0]), run(card, obs[0].to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())
    lw, gw = _objective(cfg, cpu, obs)
    lg, gg = _objective(cfg, card, obs.to(cuda))
    assert abs(lg - lw) <= 1e-10 * abs(lw)
    assert _grad_err(gg, gw) <= 1e-10


FNO3D_ENGINE_CASES = [(2, 4, 10, 10, 10, 3, 0.1), (2, 4, 9, 8, 7, 3, 0.1),
                      (2, 4, 16, 16, 8, 5, 0.1),
                      (4, 24, 64, 64, 64, 16, 1 / 24)]


@pytest.mark.parametrize("b,c,nx,ny,nz,modes,scale", FNO3D_ENGINE_CASES)
def test_fno3d_engines_agree_on_card(cuda, b, c, nx, ny, nz, modes, scale):
    """The 3D fft engine (cuFFT, irfft3) against the matmul engine with
    random complex weights, whose mixed spectrum is not Hermitian on kz =
    0, float32 (the last case is the served fno3d_a's shape)."""
    from ns_tpu_torch.models.fno3d import (SpectralWeights3D,
                                           _spectral_conv3d_fft,
                                           _spectral_conv3d_matmul)

    gen = torch.Generator().manual_seed(0)
    mx, my, mz = min(modes, nx // 2), min(modes, ny // 2), min(modes,
                                                               nz // 2 + 1)
    s = SpectralWeights3D(c, c, 4 * mx * my * mz, scale, generator=gen)
    W = s.mixing_table(torch.float32).detach().to(cuda)
    x = torch.randn(b, c, nx, ny, nz, generator=gen).to(cuda)
    torch.testing.assert_close(_spectral_conv3d_fft(W, x, mx, my, mz),
                               _spectral_conv3d_matmul(W, x, mx, my, mz),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("n", [16, 64])
def test_divergence_max_card_vs_cpu_not_band_limited(cuda, n):
    """The 3D fft engine's inverse (cuFFT's C2R) on i*k spectra of a field
    that is not band-limited (its Nyquist rows are not Hermitian), float64,
    card against CPU."""
    cfg = s3.Spectral3DConfig(nx=n, ny=n, nz=n, dtype="float64")
    u = torch.randn(3, n, n, n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    uh = torch.fft.rfftn(u, dim=(-3, -2, -1))
    want = float(s3.divergence_max(cfg, uh))
    got = float(s3.divergence_max(cfg, uh.to(cuda)))
    assert abs(got - want) <= 1e-12 * want


def _turbulence3d(cuda, path, n, nt):
    cfg = s3.Spectral3DConfig(nx=n, ny=n, nz=n, dt=5e-3, nu=5e-3)
    u0 = s3.random_solenoidal_velocity(cfg, seed=0, k_peak=3.0)
    fields = s3.simulate_strided(cfg, u0, nt, stride=4, device=cuda)
    np.savez(path, **{k: f.cpu().numpy() for k, f in zip("uvwp", fields)})
    return str(path)


def test_fno3d_a_served_on_card_matches_cpu(cuda, tmp_path):
    """A fno3d_a checkpoint (24^3, width 8) served on the card: float32
    replies within 1e-4 of max|u| of the CPU's over 4 steps at B = 2,
    finite, chunked equal to unchunked, spectral divergence <= 1e-5 of
    max|u|."""
    import dataclasses

    from ns_tpu_torch.serve import InferenceEngine
    from ns_tpu_torch.train.checkpoint import params_to_jax, save_checkpoint
    from ns_tpu_torch.train.trainer import TrainConfig, build_model

    n = 24
    cfg = TrainConfig(model="fno3d_a", fno_width=8, fno_modes=6)
    save_checkpoint({"params": params_to_jax(build_model(
        cfg, n, n, n, generator=torch.Generator().manual_seed(3))),
        "opt_state": {}}, str(tmp_path),
        meta={"config": dataclasses.asdict(cfg), "grid": [n, n, n]})
    with np.load(_turbulence3d(cuda, tmp_path / "d.npz", n, 2)) as d:
        x = np.stack([d[k] for k in "uvwp"], axis=1).astype(np.float32)
    card = InferenceEngine.from_checkpoint(str(tmp_path), chunk=3)
    cpu = InferenceEngine.from_checkpoint(str(tmp_path), device="cpu")
    got, want = card.predict(x, 4), cpu.predict(x, 4)
    assert np.isfinite(got).all()
    umax = np.abs(want[:, :, :3]).max()
    assert np.abs(got - want).max() <= 1e-4 * umax
    whole = InferenceEngine.from_checkpoint(str(tmp_path), chunk=64)
    np.testing.assert_array_equal(whole.predict(x, 4), got)
    u = torch.as_tensor(got[:, :, :3], dtype=torch.float64)
    uh = torch.fft.rfftn(u, dim=(-3, -2, -1))
    k = torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64)
    kz = torch.fft.rfftfreq(n, 1.0 / n, dtype=torch.float64)
    div = s3.irfft3(s3._ik_mul(k[:, None, None], uh[..., 0, :, :, :])
                    + s3._ik_mul(k[None, :, None], uh[..., 1, :, :, :])
                    + s3._ik_mul(kz, uh[..., 2, :, :, :]), (n, n, n))
    assert float(div.abs().max()) <= 1e-5 * float(u.abs().max())


def test_3d_training_after_a_served_rollout(cuda, tmp_path):
    """Tables first built by a served 3D rollout (torch.inference_mode)
    are saved for a later training backward in the same process; the
    training step is the 4-step remat objective with the card's
    generator, and 2 + a resume of 2 equal 4."""
    from ns_tpu_torch.serve import InferenceEngine
    from ns_tpu_torch.train.trainer import TrainConfig, Trainer

    n, nt = 20, 8
    npz = _turbulence3d(cuda, tmp_path / "d.npz", n, nt)
    base = dict(model="fno3d_a", npz_path=npz, fno_width=6, fno_modes=5,
                n_frames=nt, ckpt_every=2, batch_size=2, input_noise=0.05,
                fno_rollout_steps=4, fno_remat=True, lr_schedule="cosine",
                warmup_iters=1, grad_clip=1.0)
    Trainer(TrainConfig(out_dir=str(tmp_path / "s"), n_iters=0, **base)
            ).save(0)
    with np.load(npz) as d:
        x = np.stack([d[k][0] for k in "uvwp"]).astype(np.float32)
    eng = InferenceEngine.from_checkpoint(str(tmp_path / "s"), chunk=2)
    assert np.isfinite(eng.predict(x, 3)).all()
    whole = Trainer(TrainConfig(out_dir=str(tmp_path / "w"), n_iters=4,
                                **base))
    losses = whole.train(progress=False)
    assert np.isfinite(losses).all()
    Trainer(TrainConfig(out_dir=str(tmp_path / "h"), n_iters=2, **base)
            ).train(progress=False)
    half = Trainer(TrainConfig(out_dir=str(tmp_path / "h"), n_iters=4,
                               resume=str(tmp_path / "h" / "checkpoint.npz"),
                               **base))
    assert half.train(progress=False) == losses


# --- the runtime engines, serving and the native writer ----------------------


def _fd_engine(family, n, nt, **kw):
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.runtime import FDRolloutEngine
    from ns_tpu_torch.solvers import chorin_fd, direct_fd

    base = dict(nt=nt, nx=n, ny=n, dt=kw.pop("dt", 1e-3),
                nu=kw.pop("nu", 0.1))
    cfg = (chorin_fd.ChorinFDConfig(method="explicit", **base, **kw)
           if family == "chorin_fd" else direct_fd.DirectFDConfig(**base,
                                                                  **kw))
    z = np.zeros((n, n), np.float32)
    return FDRolloutEngine(family, cfg, *cavity_bcs(2.0 / (n - 1),
                                                   2.0 / (n - 1))), (z, z, z)


@pytest.mark.parametrize("case", [
    ("chorin_fd", 51, 120, {}),                                 # K1 + K3
    ("direct_fd", 50, 120, {"nit": 50}),                        # K2
    ("chorin_fd", 1024, 12, {"dt": 1e-5, "nu": 0.01}),          # K4 + K3
    ("direct_fd", 1024, 7, {"dt": 1e-5, "nu": 0.01, "nit": 50}),  # K2mb
])
def test_fd_engine_replay_equals_eager(cuda, case):
    """The captured rollout (a chunk graph replayed, a remainder graph) is
    bitwise the eager loop, with the kernels inside the graphs."""
    family, n, nt, kw = case
    eng, ics = _fd_engine(family, n, nt, **kw)
    assert eng.captured, eng.eager_reason
    got, want = eng(*ics), eng.eager(*ics)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)
    assert "captured=True" in repr(eng)
    again = eng(*ics)  # a second call overwrites nothing it returned
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_fd_engine_with_a_host_gate_runs_eagerly(cuda):
    """K4 at 4096^2 float32 takes its group route, whose gate is read on
    the host: the engine cannot capture it, says so, and runs eagerly."""
    eng, ics = _fd_engine("chorin_fd", 4096, 2, dt=1e-6, nu=0.01, nit=20)
    assert eng.captured is False
    assert "synchronizing" in eng.eager_reason
    assert eng.stats()["captured"] is False
    got, want = eng(*ics), eng.eager(*ics)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_periodic_engines_replay_equals_eager(cuda):
    from ns_tpu_torch.runtime import Rollout3DEngine, RolloutEngine

    cfg = sp.SpectralPeriodicConfig(nt=70, nx=256, ny=256, dt=5e-4, nu=1e-4,
                                    transform="matmul",
                                    matmul_precision="default",
                                    compact_spectrum=True)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=0, k_peak=10.0)
    eng = RolloutEngine(cfg)
    assert eng.captured and eng.stats()["graphs"] == ["chunk", "finish",
                                                     "init", "rest"]
    assert torch.equal(eng(w0), eng.eager(w0))
    c3 = s3.Spectral3DConfig(nt=3, nx=128, ny=128, nz=128,
                             transform="matmul", matmul_precision="default",
                             use_pallas_transform="auto")
    assert c3.use_pallas_transform is True
    e3 = Rollout3DEngine(c3)
    u0 = s3.taylor_green_velocity(c3)
    assert e3.captured and torch.equal(e3(u0), e3.eager(u0))
    names = [n for n, _ in e3.replay_records("rest")]
    assert any("lamb_phys_bf16_kernel" in n for n in names)


# --- the kernels' operators and the exports that carry them -----------------


def _op_args(name, device):
    """Operator arguments of one route on the card, float32 at main-path
    widths that opcheck's repeated calls keep short: K1 51^2, K2 50^2,
    K2mb and K4 256^2 (resident), K5 257x255, K3 51^2, K6-K8 32^3."""
    from ns_tpu_torch.ops.kernels import poisson_kernels as pk

    f32 = torch.float32
    h = 0.04
    plan = pk.edge_plan(tuple(p_bcs(h)))
    if name in ("jacobi_fused", "jacobi_multiblock"):
        n = 50 if name == "jacobi_fused" else 256
        return (rand((2, n, n) if n == 50 else (n, n), f32, device, 0),
                rand((n, n) if n == 256 else (2, n, n), f32, device, 1),
                h, h, 20, plan)
    if name == "momentum_explicit_fused":
        f = [rand((51, 51), f32, device, i) for i in range(4)]
        return (*f, 1e-3, h, h, 0.1, plan, pk.edge_plan(tuple(
            p_bcs(h)[::-1])), True)
    if name.startswith("sor"):
        shape = {"sor_redblack_fused": (2, 51, 51),
                 "sor_redblack_packed_multiblock": (256, 256),
                 "sor_redblack_multiblock": (257, 255)}[name]
        args = (rand(shape, f32, device, 2), rand(shape, f32, device, 3, 1e-3),
                h, h, 1.25, 5e-6, 40)
        return args if name == "sor_redblack_fused" else args + (8,)
    cfg = s3.Spectral3DConfig(nx=32, ny=32, nz=32, transform="matmul")
    M = s3._dft_tables(cfg, device)
    ry, kzc = M["Fy_t"].shape[0], M["Fz_t"].shape[0]
    if name == "fused_zy_forward":
        return (rand((3, 32, 32, 32), f32, device, 4), M["Fz_t"], M["Fy_t"],
                "default")
    a = torch.complex(rand((6, 32, ry, kzc), f32, device, 5),
                      rand((6, 32, ry, kzc), f32, device, 6))
    if name == "fused_yz_inverse":
        return (a[:3].contiguous(), M["Fyi_t"], M["Bz"], 32, "highest")
    return (a, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"], 32, "default")


@pytest.mark.parametrize("name", [w.__name__
                                  for w in kernels.WRAPPERS.values()])
def test_opcheck_on_the_card(cuda, name):
    """torch.library.opcheck on CUDA tensors (schema, fake against real
    outputs, AOT dispatch): each call launches the kernel."""
    wrapper = getattr(kernels, name)
    n0 = wrapper.launches
    torch.library.opcheck(getattr(torch.ops.ns_tpu, name).default,
                          _op_args(name, cuda))
    assert wrapper.launches > n0


def _export_case(case, tmp_path):
    """(engine, inputs, loaded artifact, kernels) of a configuration that
    runs hand-written kernels, exported on the card."""
    from ns_tpu_torch import runtime
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.solvers import chorin_fd, direct_fd

    path = str(tmp_path / f"{case}.pt2z")
    if case == "fused 64^3":
        cfg = s3.Spectral3DConfig(nt=6, nx=64, ny=64, nz=64,
                                  transform="matmul",
                                  matmul_precision="default",
                                  use_pallas_transform=True)
        eng = runtime.Rollout3DEngine(cfg)
        run = runtime.load_rollout3d_artifact(
            runtime.export_rollout3d(cfg, path))
        return (eng, eng._inputs(s3.taylor_green_velocity(cfg)), run,
                {"fused_zy_forward", "fused_lamb"})
    n = 51 if case == "chorin_fd explicit 51^2" else 50
    bcs = cavity_bcs(2.0 / (n - 1), 2.0 / (n - 1))
    if n == 51:
        family, want = "chorin_fd", {"sor_redblack_fused",
                                     "momentum_explicit_fused"}
        cfg = chorin_fd.ChorinFDConfig(nt=60, nx=n, ny=n, nit=200, nu=0.1,
                                       method="explicit")
    else:
        family, want = "direct_fd", {"jacobi_fused"}
        cfg = direct_fd.DirectFDConfig(nt=60, nx=n, ny=n, nu=0.1)
    eng = runtime.FDRolloutEngine(family, cfg, *bcs)
    run = runtime.load_fd_rollout_artifact(
        runtime.export_fd_rollout(family, cfg, *bcs, path))
    z = np.zeros((n, n), np.float32)
    return eng, eng._inputs(z, z, z), run, want


@pytest.mark.parametrize("case", ["chorin_fd explicit 51^2",
                                  "direct_fd 50^2", "fused 64^3"])
def test_kernel_artifact_matches_its_engine(cuda, tmp_path, case):
    """An artifact of a kernel configuration, exported on the card, is its
    engine's eager loop bitwise and launches the same kernels as often
    (the operators launch them, not the twins); the engine still captures
    its step, and the replay is the eager loop bitwise."""
    eng, inputs, run, want_kernels = _export_case(case, tmp_path)
    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)  # noqa: E731
    counts = []
    outs = []
    for fn in (lambda: eng.eager(*inputs), lambda: run(*inputs)):
        kernels.reset_launch_counts()
        outs.append(as_tuple(fn()))
        torch.cuda.synchronize()
        counts.append({k: v for k, v in kernels.launch_counts().items()
                       if v})
    assert counts[0] == counts[1] and want_kernels <= set(counts[1])
    for g, w in zip(*outs):
        assert torch.isfinite(g).all() and torch.equal(g, w)
    assert eng.captured, eng.eager_reason
    for g, w in zip(as_tuple(eng(*inputs)), outs[0]):
        assert torch.equal(g, w)


def test_server_round_trip_on_the_card(cuda):
    import threading

    from ns_tpu_torch.serve import ServeClient, SolverEngine
    from ns_tpu_torch.serve.server import make_server

    eng = SolverEngine(64, 64, stride=5, chunk=3)
    httpd = make_server(eng, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        c = ServeClient("127.0.0.1", httpd.server_address[1])
        assert c.health()["model"] == "solver:spectral_periodic"
        x = np.zeros((3, 64, 64), np.float32)
        x[0] = np.sin(np.linspace(0, 2 * np.pi, 64, endpoint=False))[None]
        out = c.rollout(x, 4)
        assert out.shape == (5, 3, 64, 64) and np.isfinite(out).all()
        np.testing.assert_array_equal(out, eng.predict(x, 4))
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_native_writer_builds_from_the_port(tmp_path):
    """The native backend builds from ns_tpu_torch/csrc/stream_writer.cpp
    into ns_tpu_torch/_build/ (g++ on the card's machine)."""
    from ns_tpu_torch.io import AsyncNpyWriter
    from ns_tpu_torch.runtime.native import build

    data = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    with AsyncNpyWriter(str(tmp_path / "n.npy"), data.shape,
                        backend="native") as w:
        w.write(0, data)
    np.testing.assert_array_equal(np.load(tmp_path / "n.npy"), data)
    assert build._SO.endswith(os.path.join("ns_tpu_torch", "_build",
                                           "_ns_native.so"))


# --- scale-out: ensembles and the sharded solver on the card ------------------


@pytest.mark.parametrize("family", ["chorin_fd", "direct_fd"])
def test_fd_ensemble_members_are_their_single_rollouts(cuda, family):
    """ensemble_fd_rollout steps each member through the same kernels (K1
    and K3, or K2) as its own rollout: bitwise equal on the card."""
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.core.state import FlowState
    from ns_tpu_torch.parallel.ensemble import ensemble_fd_rollout
    from ns_tpu_torch.solvers import chorin_fd, direct_fd

    rng = np.random.default_rng(0)
    if family == "chorin_fd":
        cfg = chorin_fd.ChorinFDConfig(nt=10, nit=200, nx=51, ny=51,
                                       dt=0.001, rho=1.0, nu=0.1,
                                       method="explicit")
        bc = cavity_bcs(cfg.dx, cfg.dy)
        z = np.zeros((51, 51))
        step = chorin_fd.make_step(cfg, *bc, device=cuda)
        members = [chorin_fd.init_state(cfg, 0.01 * rng.normal(size=(51, 51)),
                                        z, z, *bc, device=cuda)
                   for _ in range(4)]
        want = {"sor_redblack_fused", "momentum_explicit_fused"}
    else:
        cfg = direct_fd.DirectFDConfig(nt=10, nit=50, nx=50, ny=50)
        step = direct_fd.make_step(cfg, *cavity_bcs(cfg.dx, cfg.dy))
        members = [FlowState(*(torch.as_tensor(
            0.01 * rng.normal(size=(50, 50)), dtype=torch.float32,
            device=cuda) for _ in range(3))) for _ in range(4)]
        want = {"jacobi_fused"}
    fields = [f for f in ("u", "v", "p", "u_prev", "v_prev")
              if getattr(members[0], f) is not None]
    batch = FlowState(**{f: torch.stack([getattr(s, f) for s in members])
                         for f in fields})
    kernels.reset_launch_counts()
    got = ensemble_fd_rollout(step, batch, cfg.nt)
    torch.cuda.synchronize()
    assert want <= {k for k, v in kernels.launch_counts().items() if v}
    for i, s in enumerate(members):
        for _ in range(cfg.nt):
            s = step(s)
        for f in fields:
            assert torch.equal(getattr(got, f)[i], getattr(s, f)), (i, f)


@pytest.mark.parametrize("engine", ["fft64", "compact_high",
                                    "compact_default"])
def test_spectral_ensemble_matches_single_rollouts(cuda, engine):
    """B = 8 through ensemble_init + ensemble_rollout_final against each
    member's own rollout on the card: float64 fft <= 1e-10 and float32
    compact 'high' <= 1e-5 of max|w|; compact 'default', whose batched bf16
    GEMMs sum in another order than the single ones and round the sums to
    bf16 at the next stage, within DEFAULT_CARD_VS_CPU_2D (w_hat 1e-4,
    N_prev 2e-3 of their max: the bounds of the same engine summed in
    another order, card against CPU, chip_smoke.py's phase 5; its B = 64
    1024^2 ensemble, 20 steps, is held to 5e-4 and 4e-3). Prints each
    engine's largest error (PERF.md records the readings)."""
    from ns_tpu_torch.parallel.ensemble import (ensemble_energy,
                                                ensemble_init,
                                                ensemble_rollout_final)
    if engine == "fft64":
        cfg = sp.SpectralPeriodicConfig(nt=10, nx=64, ny=64, dt=0.005,
                                        nu=1e-3, dtype="float64")
    else:
        cfg = sp.SpectralPeriodicConfig(
            nt=10, nx=128, ny=128, dt=5e-4, nu=1e-4, transform="matmul",
            matmul_precision=engine.split("_")[1], compact_spectrum=True)
    w0 = np.stack([sp.decaying_turbulence_vorticity(cfg, seed=s)
                   for s in range(8)])
    final = ensemble_rollout_final(cfg, ensemble_init(cfg, w0, device=cuda))
    worst = {}
    for b in range(8):
        one = sp.rollout_final(cfg, sp.init_from_vorticity(cfg, w0[b], cuda))
        if engine == "compact_default":
            for part, got, want in zip(DEFAULT_CARD_VS_CPU_2D, final, one):
                err = float((got[b] - want).abs().max() / want.abs().max())
                worst[part] = max(worst.get(part, 0.0), err)
                assert err <= DEFAULT_CARD_VS_CPU_2D[part]
            continue
        got = sp.physical_from_carry(cfg, final[0][b])
        want = sp.physical_from_carry(cfg, one[0])
        bound = 1e-10 if engine == "fft64" else 1e-5
        err = float((got - want).abs().max() / want.abs().max())
        worst["w"] = max(worst.get("w", 0.0), err)
        assert err <= bound
    print(f"ensemble B=8 {engine}: largest error of max {worst}")
    assert float(ensemble_energy(cfg, final[0])) > 0


def test_sharded_spectral_on_a_world_of_one_nccl(cuda, tmp_path):
    """A world of 1 on NCCL, the all_to_all path not skipped: the sharded
    compact and fft rollouts against the single-device port in float64
    (<= 1e-11), with one all_to_all a transform counted; the compact one
    at float32 'default' is the single-device engine bitwise (its own GEMM
    stages, nonlinear term and step)."""
    from ns_tpu_torch.parallel import distributed as dist
    from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
    from ns_tpu_torch.parallel.mesh import shard
    from ns_tpu_torch.parallel.spectral_sharded import (
        make_sharded_compact_rollout, make_sharded_rollout)

    dist.initialize("file://" + str(tmp_path / "init"), 1, 0, "cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = dist.make_global_mesh({"x": 1})
        for make, kw in ((make_sharded_compact_rollout,
                          dict(transform="matmul", matmul_precision="highest",
                               compact_spectrum=True)),
                         (make_sharded_rollout, {})):
            cfg = sp.SpectralPeriodicConfig(nt=8, nx=64, ny=64, dt=0.005,
                                            nu=1e-3, dtype="float64", **kw)
            w0 = sp.decaying_turbulence_vorticity(cfg, seed=1)
            roll, sharding = make(cfg, mesh)
            reset_counts()
            got = roll(shard(sharding, w0)).local
            assert COUNTS["all_to_all@x"] > 0
            carry = sp.init_from_vorticity(cfg, w0, cuda)
            want = sp.physical_from_carry(cfg, sp.rollout_final(cfg,
                                                                carry)[0])
            assert float((got - want).abs().max()) <= 1e-11
        cfg = sp.SpectralPeriodicConfig(nt=8, nx=256, ny=256, dt=5e-4,
                                        nu=1e-4, transform="matmul",
                                        matmul_precision="default",
                                        compact_spectrum=True)
        w0 = sp.decaying_turbulence_vorticity(cfg, seed=1)
        roll, sharding = make_sharded_compact_rollout(cfg, mesh)
        want = sp.physical_from_carry(cfg, sp.rollout_final(
            cfg, sp.init_from_vorticity(cfg, w0, cuda))[0])
        assert torch.equal(roll(shard(sharding, w0)).local, want)
    finally:
        dist.shutdown()


def test_world_of_one_mesh_without_a_process_group(cuda):
    """The single-card path: a mesh of one rank with no process group on
    the card (this machine's torch builds it without a backend), its
    collectives the identity, the sharded compact rollout equal to the
    single-device one (float64)."""
    from ns_tpu_torch.parallel import make_mesh
    from ns_tpu_torch.parallel.mesh import axis_index, member_range, shard
    from ns_tpu_torch.parallel.spectral_sharded import (
        make_sharded_compact_rollout)

    assert not torch.distributed.is_initialized()
    mesh = make_mesh({"x": 1})
    assert mesh.device_type == "cuda" and axis_index(mesh, "x") == 0
    assert member_range(4, make_mesh(), "ensemble") == (0, 4)
    cfg = sp.SpectralPeriodicConfig(nt=4, nx=64, ny=64, dt=0.005, nu=1e-3,
                                    dtype="float64", transform="matmul",
                                    matmul_precision="highest",
                                    compact_spectrum=True)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=2)
    roll, sharding = make_sharded_compact_rollout(cfg, mesh)
    got = roll(shard(sharding, w0)).local
    want = sp.physical_from_carry(cfg, sp.rollout_final(
        cfg, sp.init_from_vorticity(cfg, w0, cuda))[0])
    assert float((got - want).abs().max()) <= 1e-11


def _sharded_cases(cuda):
    """(label, sharded result, single-device result, bound) of the three
    sharded solvers in float64 on a mesh of one rank: chorin_fd explicit
    (redblack at a fixed sweep count, against K1 and K3) and dst,
    chorin_spectral's corrected mode (against the dense engine) and the
    3D compact rollout (against the plain compact route)."""
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.parallel import (chorin_fd_sharded,
                                       chorin_spectral_sharded,
                                       make_mesh, spectral3d_sharded)
    from ns_tpu_torch.parallel.mesh import shard
    from ns_tpu_torch.solvers import chorin_fd, chorin_spectral

    mesh = make_mesh({"x": 1})
    out = []
    for method, mode in (("explicit", "redblack"), ("semi_implicit", "dst")):
        cfg = chorin_fd.ChorinFDConfig(nt=5, nit=41, nx=64, ny=64, dt=1e-3,
                                       nu=0.1, method=method,
                                       pressure_mode=mode, sor_tol=0.0)
        bcs = cavity_bcs(cfg.dx, cfg.dy)
        z = np.zeros((64, 64))
        s0 = chorin_fd.init_state(cfg, z, z, z, *bcs, dtype=torch.float64,
                                  device=cuda)
        got = chorin_fd_sharded.simulate(cfg, s0, *bcs, mesh,
                                         dtype=torch.float64)
        want = chorin_fd.simulate(cfg, s0, *bcs)
        out.append((f"chorin_fd {mode}", got[2].local, want[2], 1e-10))
    cfg = chorin_spectral.ChorinSpectralConfig(
        nt=5, nx=32, ny=32, dt=1e-3, nu=0.1, quirk_compat=False,
        deflate_pressure_nullspace=True)
    bc = cavity_bcs(0.1, 0.1)[0]
    x = np.cos(np.pi * np.arange(32) / 31)
    u0 = np.outer(1 - x**2, 1 - x**2)
    z = np.zeros((32, 32))
    s0 = chorin_spectral.init_state(cfg, u0, z, z, bc, bc, device=cuda)
    got = chorin_spectral_sharded.simulate(cfg, s0, bc, bc, mesh)
    want = chorin_spectral.simulate(
        cfg, s0, chorin_spectral.make_step(cfg, bc, bc, device=cuda))
    out.append(("chorin_spectral", got[0].local, want[0], 1e-12))
    cfg = s3.Spectral3DConfig(nt=5, nx=16, ny=12, nz=12, dt=1e-3, nu=1e-3,
                              dtype="float64", transform="matmul",
                              matmul_precision="highest")
    u0 = s3.random_solenoidal_velocity(cfg, seed=0, k_peak=2.0)
    roll, sharding = spectral3d_sharded.make_sharded_rollout3d(cfg, mesh)
    got = roll(shard(sharding, u0)).local
    want = s3.fields_from_hat(cfg, s3.rollout_final(
        cfg, s3.init_from_velocity(cfg, u0, device=cuda))[0])
    out.append(("spectral3d", got, want, 1e-12 * float(want.abs().max())))
    return out


def test_sharded_solvers_on_a_world_of_one_card(cuda):
    """The sharded chorin_fd, chorin_spectral and spectral3d solvers on a
    mesh of one rank with no process group, against the single-device
    routes on the card, float64."""
    assert not torch.distributed.is_initialized()
    for label, got, want, bound in _sharded_cases(cuda):
        err = float((got - want).abs().max())
        print(f"{label}: sharded vs single-device {err:.3e}")
        assert err <= bound, label


def test_sharded_solvers_on_a_world_of_one_nccl(cuda, tmp_path):
    """The same on a world of 1 on NCCL: the SOR gate's all-reduce, the
    Chebyshev all_gathers and the 3D all_to_all go through NCCL."""
    from ns_tpu_torch.parallel import distributed as dist
    from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts

    dist.initialize("file://" + str(tmp_path / "init"), 1, 0, "cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        reset_counts()
        for label, got, want, bound in _sharded_cases(cuda):
            assert float((got - want).abs().max()) <= bound, label
        for kind in ("all_reduce", "all_gather", "all_to_all"):
            assert COUNTS[f"{kind}@x"] > 0, kind
    finally:
        dist.shutdown()


def test_dp_one_under_a_world_of_one_mesh_is_the_plain_trainer(cuda,
                                                                 tmp_path):
    """cli.train --dist --dp 1 on the one card: the {'data': 1} mesh over
    NCCL runs the loss and gradient all-reduces, and its losses and
    checkpoint equal the plain Trainer's, bitwise."""
    from ns_tpu_torch.parallel import distributed as dist
    from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
    from ns_tpu_torch.train.trainer import TrainConfig, Trainer, make_dp_mesh

    rng = np.random.default_rng(7)
    path = str(tmp_path / "d.npz")
    np.savez(path, **{k: rng.normal(size=(10, 32, 32)) for k in "uvp"})
    kw = dict(model="fno_w", npz_path=path, n_iters=4, n_frames=10,
              ckpt_every=2, fno_modes=6, fno_width=8)
    plain = Trainer(TrainConfig(out_dir=str(tmp_path / "plain"), **kw),
                    device=cuda)
    want = plain.train(progress=False)
    dist.initialize("file://" + str(tmp_path / "init"), 1, 0, "cuda")
    try:
        cfg = TrainConfig(out_dir=str(tmp_path / "dp"), **kw)
        tr = Trainer(cfg, device=cuda, mesh=make_dp_mesh(cfg))
        reset_counts()
        got = tr.train(progress=False)
        assert COUNTS["all_reduce@data"] == 2 * 4
        assert set(COUNTS) == {"all_reduce", "all_reduce@data"}
    finally:
        dist.shutdown()
    assert got == want
    with np.load(tmp_path / "dp" / "checkpoint.npz") as a, \
            np.load(tmp_path / "plain" / "checkpoint.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


# --- the batched kernels: K1, K2 and K3 with a member axis --------------------
#
# The FD ensemble's form of the kernels (the JAX package's under vmap): one
# launch for a (B, nx, ny) batch, one block (K1, K2) or one block plane
# (K3) a member. Odd B puts odd members of a 51^2 float32 batch at 4-byte
# offsets.


def sor_batch(n, dtype, cuda, B=5):
    """A K1 batch whose members close their gates at different sweeps: one
    at rest, one started at its own solution, the others random."""
    h = 2.0 / (n - 1)
    p = rand((B, n, n), dtype, cuda, 40)
    c = rand((B, n, n), dtype, cuda, 41, h * h)
    p[1], c[1] = 0.0, 0.0
    p[2] = poisson.sor_redblack(p[2], c[2], h, h, 1.25, 5e-6, 200)
    return p, c, h


@pytest.mark.parametrize("dtype,atol,n", [
    (torch.float64, 1e-10, 51), (torch.float32, 1e-4, 51),
    (torch.float64, 1e-10, 120), (torch.float32, 1e-4, 170)])
def test_batched_sor_redblack_fused(cuda, dtype, atol, n):
    """Batched K1 against its batched twin (each member its own gate), one
    launch a batch: at a fixed cap (tol 0: the member at rest stops after
    one sweep, the others run to the cap) and with a converged gate (tol
    5e-6: members stop at their own sweeps; kernel and twin may stop a
    sweep apart); at 51^2 and the largest grid one block holds."""
    p, c, h = sor_batch(n, dtype, cuda)
    k1 = kernels.sor_redblack_fused
    for tol, bound in ((0.0, atol),
                       (5e-6, 1e-4 if dtype == torch.float64 else 1e-3)):
        n0 = k1.launches
        got = k1(p, c, h, h, 1.25, tol, 200)
        assert k1.launches == n0 + 1
        close(got, poisson.sor_redblack(p, c, h, h, 1.25, tol, 200), dtype,
              bound)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_batched_jacobi_fused(cuda, dtype, atol):
    """Batched K2 against its batched twin for each BC list, one launch a
    batch."""
    shape = (5, 50, 43)
    h = 2.0 / 49
    p0, b = rand(shape, dtype, cuda, 42), rand(shape, dtype, cuda, 43, 10.0)
    for bcs in k2_bc_lists(h):
        n0 = kernels.jacobi_fused.launches
        got = kernels.jacobi_fused(p0, b, h, h, 50, bcs)
        assert kernels.jacobi_fused.launches == n0 + 1
        close(got, poisson.jacobi(p0, b, h, h, 50,
                                  bc_fn=lambda q: apply_bcs(q, bcs)),
              dtype, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(5, 51, 51), (3, 64, 37), (3, 1024, 1024)])
def test_batched_momentum_explicit_fused(cuda, dtype, atol, shape):
    """Batched K3 against its batched twin with the cavity lists and lists
    with Neumann sides, both quirk settings, one launch a batch."""
    nx, ny = shape[1:]
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    f = [rand(shape, dtype, cuda, 44 + i) for i in range(4)]
    for quirk in (True, False):
        for u_bc, v_bc in momentum_bc_lists(dx):
            args = (*f, 1e-3, dx, dy, 0.1, u_bc, v_bc, quirk)
            n0 = kernels.momentum_explicit_fused.launches
            got = kernels.momentum_explicit_fused(*args)
            assert kernels.momentum_explicit_fused.launches == n0 + 1
            for g, w in zip(got, kernels.momentum_explicit(*args)):
                close(g, w, dtype, atol)


def single_launches(wrapper, batch_args, rest):
    """The wrapper on each member in turn, each member's fields copied into
    allocations of their own (as a single rollout's are)."""
    outs = [wrapper(*(a[m].clone() for a in batch_args), *rest)
            for m in range(batch_args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [50, 51])
def test_batched_k1_k2_are_single_launches_bitwise(cuda, dtype, n):
    """One batched launch of K1 (its members closing their gates at
    different sweeps) and of K2 gives each member the bits of its own
    single launch, at 50^2 and 51^2 with B = 5."""
    p, c, h = sor_batch(n, dtype, cuda)
    for tol in (0.0, 5e-6):
        rest = (h, h, 1.25, tol, 200)
        assert torch.equal(kernels.sor_redblack_fused(p, c, *rest),
                           single_launches(kernels.sor_redblack_fused,
                                           (p, c), rest))
    b = rand(p.shape, dtype, cuda, 45, 10.0)
    rest = (h, h, 50, p_bcs(h))
    assert torch.equal(kernels.jacobi_fused(p, b, *rest),
                       single_launches(kernels.jacobi_fused, (p, b), rest))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(5, 50, 50), (5, 51, 51), (3, 1024, 1024),
                                   (3, 52, 52)])
def test_batched_k3_is_single_launches_bitwise(cuda, dtype, shape):
    """One batched launch of K3 gives each member the bits of its own
    single launch, at 50^2, 51^2 (odd float32 members 4 bytes off a
    16-byte boundary) and 1024^2; and a batch whose base sits 4 or 8 bytes
    off (a member range of a larger buffer: one element a copy) gives the
    bits of 16-byte vectors at 52^2."""
    nx = shape[1]
    h = 2.0 / (nx - 1)
    f = [rand(shape, dtype, cuda, 50 + i) for i in range(4)]
    u_bc, v_bc = momentum_bc_lists(h)[1]
    rest = (1e-3, h, h, 0.1, u_bc, v_bc, True)
    got = kernels.momentum_explicit_fused(*f, *rest)
    want = single_launches(kernels.momentum_explicit_fused, f, rest)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if nx == 52:
        n = f[0].numel()
        off = []
        for a in f:
            buf = torch.empty(n + 1, dtype=dtype, device=cuda)
            buf[1:] = a.reshape(-1)
            off.append(buf[1:].view(shape))
        assert off[0].data_ptr() % 16 != 0
        for g, w in zip(kernels.momentum_explicit_fused(*off, *rest), want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("family", ["chorin_fd", "direct_fd"])
def test_fd_ensemble_is_one_launch_a_step(cuda, family):
    """ensemble_fd_rollout at B = 9 makes one launch of each of its
    kernels a time step for the whole batch (K1 and K3, or K2), and every
    member is bitwise its single rollout."""
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.core.state import FlowState
    from ns_tpu_torch.parallel.ensemble import ensemble_fd_rollout
    from ns_tpu_torch.solvers import chorin_fd, direct_fd

    B, nt = 9, 6
    rng = np.random.default_rng(1)
    if family == "chorin_fd":
        cfg = chorin_fd.ChorinFDConfig(nt=nt, nit=200, nx=51, ny=51,
                                       dt=0.001, rho=1.0, nu=0.1,
                                       method="explicit")
        bc = cavity_bcs(cfg.dx, cfg.dy)
        z = np.zeros((51, 51))
        step = chorin_fd.make_step(cfg, *bc, device=cuda)
        members = [chorin_fd.init_state(cfg, 0.01 * rng.normal(size=(51, 51)),
                                        z, z, *bc, device=cuda)
                   for _ in range(B)]
        want = {"sor_redblack_fused", "momentum_explicit_fused"}
    else:
        cfg = direct_fd.DirectFDConfig(nt=nt, nit=50, nx=50, ny=50)
        step = direct_fd.make_step(cfg, *cavity_bcs(cfg.dx, cfg.dy))
        members = [FlowState(*(torch.as_tensor(
            0.01 * rng.normal(size=(50, 50)), dtype=torch.float32,
            device=cuda) for _ in range(3))) for _ in range(B)]
        want = {"jacobi_fused"}
    fields = [f for f in ("u", "v", "p", "u_prev", "v_prev")
              if getattr(members[0], f) is not None]
    batch = FlowState(**{f: torch.stack([getattr(s, f) for s in members])
                         for f in fields})
    kernels.reset_launch_counts()
    got = ensemble_fd_rollout(step, batch, nt)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    calls = {k: v for k, v in kernels.call_counts().items() if v}
    assert launches == {k: nt for k in want} == calls
    for i, s in enumerate(members):
        for _ in range(nt):
            s = step(s)
        for f in fields:
            assert torch.equal(getattr(got, f)[i], getattr(s, f)), (i, f)


# sha256 of the outputs of the 3D transform kernels on
# tools/torch_kernel_digests.py's inputs on an NVIDIA H100 80GB HBM3 (nvcc
# 12.9): of the 'default' kernels of K6, K7 and K8 and the 3xTF32 kernels
# of K6 and K7 from the tree before K8's 3xTF32 pair, which leaves them
# their bits, and of K8's 3xTF32 pair ('highest') from the tree that added
# it. A digest is the build's: another nvcc may schedule the sums
# otherwise.
PARENT_DIGESTS = {
    "fused_zy_forward default 256 256 256":
        "8fe71a780db5445c0d46313a5fe249a068ca76441e9f072734ff80ec837c1b91",
    "fused_zy_forward default 40 36 30":
        "eeae5a8cd82775467d1e9a66ec1c21d15d1e0d49e47e6c5d97251aa1ccf0a658",
    "fused_zy_forward default 8 300 30":
        "27e7c9ca0cdeba381813580d15ba3d1c281e6e45727b980175f733dba9f1a0d3",
    "fused_zy_forward highest 256 256 256":
        "7773740d4aaa708e301b37688d98ff15bb3d7cf41588badb3d4698d647eabc66",
    "fused_zy_forward highest 40 36 30":
        "d79a7376debeb033d6c74b1c614c706adc56f88dfff38b9d9ea9bf950d856189",
    "fused_zy_forward highest 8 300 30":
        "7c83bab986b6d90ed03dc8294dd2cc2ebca9f6533ac7e8ae8f3a3db94880417a",
    "fused_yz_inverse default 256 256 256":
        "07b2f287e8328d2c452bf00b7a12c497392727d37f13bfd28969b4d8db76c62c",
    "fused_yz_inverse default 40 36 30":
        "d292fd49120e05709c4f3dde97936e960dae93ec6a1b6af71bbad1d664270dcf",
    "fused_yz_inverse default 24 70 20":
        "1f05951dda6cd56c743cf093bc207df8e4ba41a9c8d464bf6903123734246cae",
    "fused_yz_inverse highest 256 256 256":
        "8635de48e31d4060811e6306136ff94ae59f1d1967b9430759a2c64d47842d95",
    "fused_yz_inverse highest 40 36 30":
        "9218b1cc2ffb6757ad6b92600240c8bb301cd1b39d6e044046a01f7592a70a71",
    "fused_yz_inverse highest 24 70 20":
        "71e505b41115c6a54c417e710f9f3de06b2e17226363e21bbd42865e4ff00ad2",
    "fused_lamb default 256 256 256":
        "e7750d8b029040cd5ae8ecfdc63a57de90c37bfbd3c1fc503ab3799965c2952b",
    "fused_lamb default 40 36 30":
        "48fa77de1723461f12e0cfaea25b84da463f51c653fd515a351adf87630511da",
    "fused_lamb default 24 70 20":
        "06f330f487b3c2118bcdb0b62383b2c12520020e0e9c49171049e443bec1b314",
    "fused_lamb highest 256 256 256":
        "88f53c15faf408c1930114e81468347f1eeb0e7b5956d1852e2fe56fcb9d3218",
    "fused_lamb highest 40 36 30":
        "04cb0f67974ca869f7816125f0246806a14d3896e47346010e12eb588951efbd",
    "fused_lamb highest 24 70 20":
        "08797a3c03e32c6022089d9478d2ba4971374a30176af1da47d6a3ca61ffc529",
}


@pytest.mark.parametrize("case", sorted(PARENT_DIGESTS))
def test_transform_kernels_keep_their_bits(cuda, case):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_kernel_digests.py")
    spec = importlib.util.spec_from_file_location("torch_kernel_digests",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.digest(case, cuda) == PARENT_DIGESTS[case]
