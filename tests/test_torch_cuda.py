"""The port's CUDA kernels against their plain torch twins, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. This
file imports neither jax nor the JAX package, so on a machine without jax
it runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float64 at a fixed sweep count <= 1e-10 abs (nvcc contracts to
FMA, so kernel and twin are not bitwise equal); float32 <= 1e-4 relative to
the field's max.
"""

import pytest
import torch

from ns_tpu_torch.core.bc import apply_bcs, dirichlet, neumann
from ns_tpu_torch.ops import kernels, poisson

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


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_jacobi_fused(cuda, dtype, atol):
    nx, ny = 50, 43
    h = 2.0 / (nx - 1)
    p0, b = rand((nx, ny), dtype, cuda, 0), rand((nx, ny), dtype, cuda, 1, 10.0)
    n0 = kernels.jacobi_fused.launches
    got = kernels.jacobi_fused(p0, b, h, h, 50, p_bcs(h))
    assert kernels.jacobi_fused.launches == n0 + 1
    want = poisson.jacobi(p0, b, h, h, 50,
                          bc_fn=lambda q: apply_bcs(q, p_bcs(h)))
    close(got, want, dtype, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(51, 51), (64, 37)])
def test_sor_redblack_fused(cuda, dtype, atol, shape):
    h = 2.0 / (shape[0] - 1)
    p0, c = rand(shape, dtype, cuda, 2), rand(shape, dtype, cuda, 3, h * h)
    n0 = kernels.sor_redblack_fused.launches
    got = kernels.sor_redblack_fused(p0, c, h, h, 1.25, 0.0, 200)
    assert kernels.sor_redblack_fused.launches == n0 + 1
    close(got, poisson.sor_redblack(p0, c, h, h, 1.25, 0.0, 200), dtype, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(256, 256), (257, 190)])
def test_sor_redblack_multiblock(cuda, dtype, atol, shape):
    """tol=0 and cap 8*4+1: four gated groups of k=8 sweeps on both sides."""
    h = 2.0 / (shape[0] - 1)
    p0, c = rand(shape, dtype, cuda, 4), rand(shape, dtype, cuda, 5, h * h)
    n0 = kernels.sor_redblack_multiblock.launches
    got = kernels.sor_redblack_multiblock(p0, c, h, h, 1.25, 0.0, 33)
    assert kernels.sor_redblack_multiblock.launches == n0 + 4
    close(got, kernels.sor_redblack_tiled(p0, c, h, h, 1.25, 0.0, 33), dtype,
          atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("quirk", [True, False])
def test_momentum_explicit_fused(cuda, dtype, atol, quirk):
    nx, ny = 67, 130
    h = 2.0 / (nx - 1)
    u_bc = [neumann(0.5, "left", h, h), dirichlet(1, "right"),
            neumann(-0.25, "top", h, h), dirichlet(0, "bottom")]
    v_bc = [neumann(0, "bottom", h, h), dirichlet(0, "top"),
            dirichlet(0, "left"), neumann(-1.0, "right", h, h)]
    f = [rand((nx, ny), dtype, cuda, 6 + i) for i in range(4)]
    args = (*f, 1e-3, h, h, 0.1, u_bc, v_bc, quirk)
    n0 = kernels.momentum_explicit_fused.launches
    got = kernels.momentum_explicit_fused(*args)
    assert kernels.momentum_explicit_fused.launches == n0 + 1
    for g, w in zip(got, kernels.momentum_explicit(*args)):
        close(g, w, dtype, atol)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    big = torch.zeros((200, 200), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.jacobi_fused(big, big, 0.01, 0.01, 5, [])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sor_redblack_fused(big.T, big.T, 0.01, 0.01, 1.25, 0.0, 5)
    with pytest.raises(TypeError, match="float32"):
        half = big.half()
        kernels.sor_redblack_multiblock(half, half, 0.01, 0.01, 1.25, 0.0, 5)
