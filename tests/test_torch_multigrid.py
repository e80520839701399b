"""Port multigrid (ns_tpu_torch.ops.multigrid) against the JAX package, in
float64 on the CPU.

Inputs are numpy arrays from a seeded generator fed to both packages. The
V-cycle operators run the same arithmetic in the same order: restriction
and prolongation are bitwise equal, stationary V-cycles agree <= 1e-12.
MGCG's inner products sum in another order than XLA's `vdot`, and CG
carries that through its step sizes: <= 1e-9 of the solution's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.ops import multigrid as jmg
from ns_tpu_torch.ops import multigrid as tmg
from ns_tpu_torch.ops import poisson


def problem(seed, nx, ny):
    rng = np.random.default_rng(seed)
    p0 = np.zeros((nx, ny))
    p0[0, :], p0[:, -1] = rng.normal(size=ny), rng.normal(size=nx)
    return p0, rng.normal(size=(nx, ny))


def both(fn_j, fn_t, *arrays, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_t(*(torch.as_tensor(a) for a in arrays), **kw).numpy()
    return got, want


@pytest.mark.parametrize("shape,atol", [((65, 65), 1e-12),
                                        ((51, 51), 1e-9), ((50, 50), 1e-9),
                                        ((51, 40), 1e-9)])
def test_poisson_multigrid_matches_jax(shape, atol):
    """65^2 runs stationary V-cycles; 51^2, 50^2 and 51x40 are embedded in
    the next 2^k+1 grid and run MGCG. atol is relative to max(1, max|p|)."""
    nx, ny = shape
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, f = problem(0, nx, ny)
    got, want = both(jmg.poisson_multigrid, tmg.poisson_multigrid, p0, f,
                     dx=dx, dy=dy, n_cycles=4)
    assert got.shape == want.shape == shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= atol * scale
    # and it solves: 4 cycles cut the interior residual at least 10x
    def residual(p):
        r = poisson.laplace_full(torch.as_tensor(p), dx * dx, dy * dy)
        return float((r - torch.as_tensor(f))[1:-1, 1:-1].abs().max())

    assert residual(got) < 0.1 * residual(p0)


def test_poisson_mgcg_matches_jax_on_a_pow2_grid():
    """MGCG called directly on an exact 2^k+1 grid (no embedding)."""
    p0, f = problem(1, 33, 33)
    got, want = both(jmg.poisson_mgcg, tmg.poisson_mgcg, p0, f, dx=0.0625,
                     dy=0.0625, n_iters=5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n", [5, 9, 51, 65])
def test_restrict_and_prolong_match_jax_bitwise(n):
    rng = np.random.default_rng(n)
    r = rng.normal(size=(n, n))
    got, want = both(jmg._restrict, tmg._restrict, r)
    np.testing.assert_array_equal(got, want)
    e = rng.normal(size=((n + 1) // 2, (n + 1) // 2))
    want = np.asarray(jmg._prolong(jnp.asarray(e), n, n))
    np.testing.assert_array_equal(tmg._prolong(torch.as_tensor(e)).numpy(),
                                  want)


def test_embed_and_smooth_match_jax():
    p0, f = problem(2, 23, 30)
    pj, fj, mj, ej = jmg._embed(jnp.asarray(p0), jnp.asarray(f))
    pt, ft, mt, et = tmg._embed(torch.as_tensor(p0), torch.as_tensor(f))
    assert ej is et is False and pt.shape == (33, 33)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    want = np.asarray(jmg._smooth(pj, fj, 0.01, 0.02, mj, 3))
    got = tmg._smooth(pt, ft, 0.01, 0.02, mt, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert tmg._next_pow2_plus1(51) == 65 and tmg._is_pow2_plus1(65)
