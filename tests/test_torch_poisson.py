"""Port pressure solvers (ns_tpu_torch.ops.poisson and the K1/K2/K4/K5
twins) against the JAX package.

The JAX side's Pallas kernels run in interpret mode on the CPU, as
tests/test_pallas_kernels.py runs them. Inputs are numpy arrays from a
seeded generator fed to both packages; comparisons are in float64 with the
tolerance stated at each test. The kernels themselves are held against
these twins on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import apply_bcs as j_apply_bcs
from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.ops import poisson as jpoisson
from ns_tpu.ops.pallas.poisson_kernels import (
    jacobi_fused_pallas, pack_redblack, sor_redblack_fused_pallas,
    sor_redblack_packed_tiled_pallas, sor_redblack_tiled_any,
    unpack_redblack)
from ns_tpu_torch.core.bc import BC, apply_bcs, bcs_from_reference
from ns_tpu_torch.ops import kernels, poisson
from ns_tpu_torch.ops.kernels import _build, poisson_kernels


def j_p_bcs(dx, dy):
    return [j_dirichlet(0, "top"), j_neumann(0, "bottom", dx, dy),
            j_neumann(0, "left", dx, dy), j_neumann(0, "right", dx, dy)]


def fields(seed, shape, n=2, scale=(1.0, 0.1)):
    rng = np.random.default_rng(seed)
    return [s * rng.normal(size=shape) for s in scale[:n]]


def test_jacobi_matches_jax_pallas_and_jnp():
    """Plain jacobi + BCs vs jacobi_fused_pallas(interpret) and
    poisson.jacobi: <= 1e-12 (f64, same arithmetic per cell)."""
    nx = ny = 32
    dx = dy = 2.0 / (nx - 1)
    p0, b = fields(0, (nx, ny), scale=(1.0, 1.0))
    jbcs = j_p_bcs(dx, dy)
    tbcs = bcs_from_reference(jbcs)
    want_k = np.asarray(jacobi_fused_pallas(jnp.asarray(p0), jnp.asarray(b),
                                            dx, dy, 25, jbcs, interpret=True))
    want_x = np.asarray(jpoisson.jacobi(
        jnp.asarray(p0), jnp.asarray(b), dx, dy, 25,
        bc_fn=lambda q: j_apply_bcs(q, jbcs)))
    got = poisson.jacobi(torch.as_tensor(p0), torch.as_tensor(b), dx, dy, 25,
                         bc_fn=lambda q: apply_bcs(q, tbcs)).numpy()
    np.testing.assert_allclose(got, want_k, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want_x, rtol=0, atol=1e-12)


@pytest.mark.parametrize("tol,atol", [(0.0, 1e-10), (5e-6, 1e-4)])
def test_sor_redblack_matches_jax_pallas(tol, atol):
    """tol=0 runs the cap on both sides (<= 1e-10); the converged gate may
    stop a sweep apart, hence 1e-4 as in test_pallas_kernels.py."""
    nx = ny = 33
    dx = dy = 2.0 / (nx - 1)
    p0, c = fields(1, (nx, ny))
    want = np.asarray(sor_redblack_fused_pallas(
        jnp.asarray(p0), jnp.asarray(c), dx, dy, beta=1.25, tol=tol,
        max_iter=120, interpret=True))
    got = poisson.sor_redblack(torch.as_tensor(p0), torch.as_tensor(c), dx,
                               dy, 1.25, tol, 120).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_sor_redblack_tiled_twin_matches_jax_tiled_any():
    """K5's twin (k=4) vs the pad-and-mask tiled Pallas kernel on an odd
    70x90 grid; cap 9 = two gate groups on both sides: <= 1e-9."""
    nx, ny = 70, 90
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, rhs = fields(3, (nx, ny), scale=(1.0, 1.0))
    want = np.asarray(sor_redblack_tiled_any(
        jnp.asarray(p0), jnp.asarray(rhs), dx, dy, 1.25, 0.0, 9,
        k_per_launch=4, tile_rows=32, interpret=True))
    got = kernels.sor_redblack_tiled(torch.as_tensor(p0), torch.as_tensor(rhs),
                                     dx, dy, 1.25, 0.0, 9, k=4).numpy()
    assert got.shape == (nx, ny)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_sor_redblack_tiled_twin_matches_jax_packed():
    """K5's twin vs the packed-plane tiled Pallas kernel (K4) on 128x256,
    cap 9: the two kernels' iterate sequences are the same, <= 1e-9."""
    nx, ny = 128, 256
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    (rhs,) = fields(4, (nx, ny), n=1, scale=(1.0,))
    p0 = np.zeros((nx, ny))
    want = np.asarray(sor_redblack_packed_tiled_pallas(
        jnp.asarray(p0), jnp.asarray(rhs), dx, dy, 1.25, 0.0, 9,
        k_per_launch=4, tile_rows=64, interpret=True))
    got = kernels.sor_redblack_tiled(torch.as_tensor(p0), torch.as_tensor(rhs),
                                     dx, dy, 1.25, 0.0, 9, k=4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape", [(6, 8), (7, 10), (128, 256)])
def test_pack_unpack_match_jax_bitwise(shape):
    (p,) = fields(9, shape, n=1, scale=(1.0,))
    R, B = kernels.pack_redblack(torch.as_tensor(p))
    Rj, Bj = pack_redblack(jnp.asarray(p))
    np.testing.assert_array_equal(R.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(B.numpy(), np.asarray(Bj))
    back = kernels.unpack_redblack(R, B).numpy()
    np.testing.assert_array_equal(back, np.asarray(unpack_redblack(Rj, Bj)))
    np.testing.assert_array_equal(back, p)


def test_pack_rejects_odd_ny():
    with pytest.raises(ValueError, match="even ny"):
        kernels.pack_redblack(torch.zeros((8, 7)))
    with pytest.raises(ValueError, match="even ny"):
        kernels.sor_redblack_packed_tiled(torch.zeros((8, 7)),
                                          torch.zeros((8, 7)), 0.1, 0.1,
                                          1.25, 0.0, 9)


@pytest.mark.parametrize("tol,cap", [(0.0, 9), (0.0, 33), (5e-2, 400)])
def test_packed_twin_matches_jax_packed_kernel(tol, cap):
    """K4's twin vs sor_redblack_packed_tiled_pallas(interpret) on 128x256
    (k=4, tile_rows=64): caps 9 and 33 at tol 0, and a converging tol that
    stops both at the same gate group. Same expression order: <= 1e-12."""
    nx, ny = 128, 256
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, rhs = fields(10, (nx, ny), scale=(1.0, 1e-4))
    want = np.asarray(sor_redblack_packed_tiled_pallas(
        jnp.asarray(p0), jnp.asarray(rhs), dx, dy, 1.25, tol, cap,
        k_per_launch=4, tile_rows=64, interpret=True))
    got = kernels.sor_redblack_packed_tiled(
        torch.as_tensor(p0), torch.as_tensor(rhs), dx, dy, 1.25, tol, cap,
        k=4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(67, 90), (40, 64)])
def test_packed_twin_matches_tiled_twin(shape):
    """K4's twin and K5's twin run the same iterate sequence and gate, on
    any grid with an even ny (odd nx included): <= 1e-12."""
    nx, ny = shape
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, c = (torch.as_tensor(a) for a in fields(11, shape))
    for tol, cap in ((0.0, 17), (1e-4, 300)):
        got = kernels.sor_redblack_packed_tiled(p0, c, dx, dy, 1.25, tol, cap)
        want = kernels.sor_redblack_tiled(p0, c, dx, dy, 1.25, tol, cap)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12)


def test_packed_tile_fits_shared_memory():
    """K4's tile (64x64 own packed cells plus a 2k-row, k-column halo) at
    k=8 fits one block in float32 (60 KB) and float64 (120 KB)."""
    pk = poisson_kernels
    assert pk.PACKED_TILE == (64, 64)
    assert pk.packed_tile_bytes(8, 4) == 2 * 96 * 80 * 4
    assert pk.packed_tile_bytes(8, 8) <= pk.SMEM_BUDGET
    assert pk.packed_tile_bytes(40, 8) > pk.SMEM_BUDGET


def test_sor_redblack_tiled_gate_runs_past_single_block_stop():
    """err starts at inf and `it` goes up by k: with a converged gate the
    tiled twin runs whole groups, so it matches sor_redblack at a multiple
    of k sweeps, not at sor_redblack's own stop."""
    nx = ny = 20
    dx = dy = 2.0 / (nx - 1)
    p0, c = (torch.as_tensor(a) for a in fields(5, (nx, ny)))
    # cap 7 with k=4: groups at it=1 and it=5 -> 8 sweeps (the plain solver
    # with cap 9 also runs 8)
    got = kernels.sor_redblack_tiled(p0, c, dx, dy, 1.25, 0.0, 7, k=4)
    want = poisson.sor_redblack(p0, c, dx, dy, 1.25, 0.0, 9)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-13)


def test_sor_wavefront_matches_jax():
    """Wavefront Gauss-Seidel, one 51^2 solve capped at 20 sweeps:
    <= 1e-12."""
    nx = ny = 51
    dx = dy = 2.0 / (nx - 1)
    p0, c = fields(6, (nx, ny))
    want = np.asarray(jpoisson.sor_wavefront(jnp.asarray(p0), jnp.asarray(c),
                                             dx, dy, 1.25, 5e-6, 20))
    got = poisson.sor_wavefront(torch.as_tensor(p0), torch.as_tensor(c), dx,
                                dy, 1.25, 5e-6, 20).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_cg_poisson_and_laplace_match_jax():
    """CG: the sums run in another order, so the iterates agree to
    roundoff amplified by the iteration count: <= 1e-9 at 40 iterations."""
    nx, ny = 24, 30
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, f = fields(7, (nx, ny), scale=(1.0, 1.0))
    want = np.asarray(jpoisson.cg_poisson(jnp.asarray(p0), jnp.asarray(f), dx,
                                          dy, tol=1e-10, max_iter=40))
    got = poisson.cg_poisson(torch.as_tensor(p0), torch.as_tensor(f), dx, dy,
                             tol=1e-10, max_iter=40).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    lap_j = np.asarray(jpoisson.laplace_full(jnp.asarray(p0), dx * dx, dy * dy))
    lap_t = poisson.laplace_full(torch.as_tensor(p0), dx * dx, dy * dy).numpy()
    np.testing.assert_allclose(lap_t, lap_j, rtol=1e-14, atol=1e-9)


def test_smem_fit_check():
    """Two grids per single-block kernel against 227 KB less 1 KB."""
    assert kernels.smem_fits(51, 51, 2, 8)        # 41.6 KB (K1 at 51^2 f64)
    assert kernels.smem_fits(50, 50, 2, 8)        # 40 KB (K2 at 50^2 f64)
    assert kernels.smem_fits(120, 120, 2, 8)      # 225 KB
    assert not kernels.smem_fits(121, 121, 2, 8)
    assert not kernels.smem_fits(1024, 1024, 2, 4)


def test_wrappers_take_twin_on_cpu_without_launching():
    """On CPU tensors every wrapper returns its twin's result and counts no
    launch."""
    kernels.reset_launch_counts()
    nx = ny = 17
    dx = dy = 2.0 / (nx - 1)
    p0, c = (torch.as_tensor(a) for a in fields(8, (nx, ny)))
    bcs = bcs_from_reference(j_p_bcs(dx, dy))
    assert torch.equal(
        kernels.jacobi_fused(p0, c, dx, dy, 5, bcs),
        poisson.jacobi(p0, c, dx, dy, 5, bc_fn=lambda q: apply_bcs(q, bcs)))
    assert torch.equal(kernels.sor_redblack_fused(p0, c, dx, dy, 1.25, 0.0, 9),
                       poisson.sor_redblack(p0, c, dx, dy, 1.25, 0.0, 9))
    assert torch.equal(
        kernels.sor_redblack_multiblock(p0, c, dx, dy, 1.25, 0.0, 9, k=4),
        kernels.sor_redblack_tiled(p0, c, dx, dy, 1.25, 0.0, 9, k=4))
    q0, cq = (torch.as_tensor(a) for a in fields(8, (nx, ny + 1)))
    assert torch.equal(
        kernels.sor_redblack_packed_multiblock(q0, cq, dx, dy, 1.25, 0.0, 9,
                                               k=4),
        kernels.sor_redblack_packed_tiled(q0, cq, dx, dy, 1.25, 0.0, 9, k=4))
    assert set(kernels.launch_counts().values()) == {0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc on PATH and no toolkit under CUDA_HOME: asking for the
    library raises a clear error and never returns a stub."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_library()
    _build.library.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.library()


def test_kernel_input_validation_rejects_cpu_and_bad_bcs():
    """The kernel entries take CUDA tensors only, and a BC list as its edge
    plan: a BC of an unknown kind or side is refused where it is made, and
    a list of any length (the reference p list three times) gives the plan
    of each side's last BC."""
    p = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_inputs("k", p)
    with pytest.raises(ValueError, match="kind"):
        BC("robin", 0.0, "left")
    with pytest.raises(ValueError, match="side"):
        BC("dirichlet", 0.0, "front")
    bcs = bcs_from_reference(j_p_bcs(0.5, 0.25))
    spec = list(poisson_kernels.edge_plan(tuple(bcs)))
    assert list(poisson_kernels.edge_plan(tuple(bcs * 3))) == spec
    # kind[4], corner[4], term[4] by side (left, right, bottom, top): top
    # Dirichlet 0, the others Neumann with 0 offsets; left writes the
    # corners of row 0 last, right those of row nx-1
    assert spec == [1, 1, 1, 0, 0, 0, 1, 1, -0.0, 0.0, -0.0, 0.0]
