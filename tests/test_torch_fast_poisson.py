"""Port direct solvers (ns_tpu_torch.ops.fast_poisson) against the JAX
package, in float64 on the CPU.

Inputs are numpy arrays from a seeded generator fed to both packages. Both
sides build the same float64 bases in numpy; their GEMMs sum in another
order, so each comparison allows 1e-12 of the result's scale
(max(1, max|want|)). The mixed-BC fixed-point checks use the JAX tests'
bounds (tests/test_fast_poisson.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import BC as JBC
from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.ops import fast_poisson as jfp
from ns_tpu_torch.core.bc import apply_bcs, bcs_from_reference
from ns_tpu_torch.ops import fast_poisson as tfp
from ns_tpu_torch.ops import poisson

F64 = torch.float64


def close(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale


def fields(seed, shape, n=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(n)]


@pytest.mark.parametrize("nx,ny", [(34, 34), (35, 27), (20, 41)])
@pytest.mark.parametrize("parity", [False, True])
def test_dst_poisson_matches_jax(nx, ny, parity):
    """Even and odd interior sizes, square and rectangular, with the
    parity-split engine on and off (odd m exercises its middle row)."""
    dx, dy = 2.0 / (nx - 1), 1.5 / (ny - 1)
    p0, f = fields(0, (nx, ny))
    want = jfp.make_dst_poisson(nx, ny, dx, dy, dtype=jnp.float64,
                                parity_split=parity)(jnp.asarray(p0),
                                                     jnp.asarray(f))
    got = tfp.make_dst_poisson(nx, ny, dx, dy, dtype=F64,
                               parity_split=parity)(torch.as_tensor(p0),
                                                    torch.as_tensor(f))
    close(got, want)
    np.testing.assert_array_equal(got.numpy()[0], p0[0])  # ring kept


@pytest.mark.parametrize("parity", [False, True])
def test_dst_helmholtz_matches_jax(parity):
    nx, ny = 33, 28
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    ring, rhs = fields(1, (nx, ny))
    coeff = 1e-3 * 0.1 / 2.0
    want = jfp.make_dst_helmholtz(nx, ny, dx, dy, coeff, dtype=jnp.float64,
                                  parity_split=parity)(
        jnp.asarray(ring), jnp.asarray(rhs[1:-1, 1:-1]))
    got = tfp.make_dst_helmholtz(nx, ny, dx, dy, coeff, dtype=F64,
                                 parity_split=parity)(
        torch.as_tensor(ring), torch.as_tensor(rhs[1:-1, 1:-1]))
    close(got, want)
    with pytest.raises(ValueError, match="coeff"):
        tfp.make_dst_helmholtz(nx, ny, dx, dy, -1.0)


def test_parity_threshold_and_engines_agree():
    """`_PARITY_MIN_DIM` and the auto rule are the JAX package's; the two
    engines agree to reassociation (<= 1e-12 of scale)."""
    assert tfp._PARITY_MIN_DIM == jfp._PARITY_MIN_DIM == 192
    for m, k in ((190, 300), (192, 192), (10, 500)):
        assert tfp._resolve_parity(None, m, k) == jfp._resolve_parity(
            None, m, k)
    nx, ny = 30, 23
    p0, f = (torch.as_tensor(a) for a in fields(2, (nx, ny)))
    on = tfp.make_dst_poisson(nx, ny, 0.1, 0.2, F64, parity_split=True)
    off = tfp.make_dst_poisson(nx, ny, 0.1, 0.2, F64, parity_split=False)
    close(on(p0, f), off(p0, f))


def test_dst_solve_leaves_rounding_level_residual():
    """The 5-point residual of the solved interior is at rounding level:
    <= 1e-9 of max|f| (|lap p| terms are ~1/h^2 times p)."""
    nx, ny = 40, 33
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, f = (torch.as_tensor(a) for a in fields(3, (nx, ny)))
    p = tfp.poisson_dst(p0, f, dx, dy)
    res = (poisson.laplace_full(p, dx * dx, dy * dy) - f)[1:-1, 1:-1]
    assert float(res.abs().max()) <= 1e-9 * float(f.abs().max())


def test_poisson_dst_is_memoised():
    nx, ny = 12, 15
    p0, f = (torch.as_tensor(a) for a in fields(4, (nx, ny)))
    tfp._cached_dst_solver.cache_clear()
    a = tfp.poisson_dst(p0, f, 0.1, 0.1)
    b = tfp.poisson_dst(p0, f, 0.1, 0.1)
    assert tfp._cached_dst_solver.cache_info().hits == 1
    assert torch.equal(a, b)
    want = jfp.poisson_dst(jnp.asarray(p0.numpy()), jnp.asarray(f.numpy()),
                           0.1, 0.1)
    close(a, want)


def j_cavity_p_bc(dx, dy):
    return [j_dirichlet(0, "top"), j_neumann(0, "bottom", dx, dy),
            j_neumann(0, "left", dx, dy), j_neumann(0, "right", dx, dy)]


def test_mixed_poisson_matches_jax_cavity():
    """direct_fd's cavity pressure BCs, h0=dy, h1=dx, with the solve's
    dtype following b's (dtype=None) or forced."""
    nx, ny = 26, 31
    dx, dy = 2.0 / (ny - 1), 2.0 / (nx - 1)
    jbc = j_cavity_p_bc(dx, dy)
    (b,) = fields(5, (nx, ny), n=1)
    want = jfp.make_mixed_poisson(nx, ny, dy, dx, jbc)(jnp.asarray(b))
    tbc = bcs_from_reference(jbc)
    for dtype in (None, F64):
        got = tfp.make_mixed_poisson(nx, ny, dy, dx, tbc, dtype=dtype)(
            torch.as_tensor(b))
        close(got, want)


def test_mixed_poisson_all_neumann_deflated():
    """Singular all-Neumann problem: the nullspace pair is deflated as in
    ns_tpu (<= 1e-12 of scale), and for a compatible b the result is a
    fixed point of one Jacobi sweep + BCs (<= 1e-10)."""
    nx = ny = 17
    dx = dy = 2.0 / (nx - 1)
    jbc = [j_neumann(0.0, s, dx, dy) for s in ("left", "right", "bottom",
                                                "top")]
    rng = np.random.default_rng(7)
    b_int = rng.normal(size=(nx - 2, ny - 2))
    b_int -= b_int.mean()
    b = np.zeros((nx, ny))
    b[1:-1, 1:-1] = b_int
    want = jfp.make_mixed_poisson(nx, ny, dy, dx, jbc)(jnp.asarray(b))
    tbc = bcs_from_reference(jbc)
    p = tfp.make_mixed_poisson(nx, ny, dy, dx, tbc)(torch.as_tensor(b))
    close(p, want)
    after = poisson.jacobi(p, torch.as_tensor(b), dx, dy, 1,
                           bc_fn=lambda q: apply_bcs(q, tbc))
    np.testing.assert_allclose(after.numpy(), p.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mixed_poisson_random_bc_combinations(seed):
    """Random per-side BC kinds, values and steps on random rectangular
    grids (the JAX property test's draw): the port equals ns_tpu
    (<= 1e-12 of scale) and is a fixed point of one Jacobi sweep + BCs
    (<= 1e-9, the JAX test's bound)."""
    rng = np.random.default_rng(seed)
    nx, ny = int(rng.integers(8, 30)), int(rng.integers(8, 30))
    dx, dy = float(rng.uniform(0.05, 0.5)), float(rng.uniform(0.05, 0.5))
    sides = ["left", "right", "bottom", "top"]
    kinds = [str(rng.choice(["dirichlet", "neumann"])) for _ in sides]
    if all(k == "neumann" for k in kinds):
        kinds[rng.integers(0, 4)] = "dirichlet"  # keep nonsingular
    jbc = [JBC(k, float(rng.normal()), s, dx=dx, dy=dy)
           for k, s in zip(kinds, sides)]
    b = rng.normal(size=(nx, ny))
    want = jfp.make_mixed_poisson(nx, ny, dy, dx, jbc)(jnp.asarray(b))
    tbc = bcs_from_reference(jbc)
    p = tfp.make_mixed_poisson(nx, ny, dy, dx, tbc)(torch.as_tensor(b))
    close(p, want)
    after = poisson.jacobi(p, torch.as_tensor(b), dx, dy, 1,
                           bc_fn=lambda q: apply_bcs(q, tbc))
    np.testing.assert_allclose(after.numpy(), p.numpy(), rtol=0, atol=1e-9)


def test_side_bcs_needs_one_bc_per_side():
    with pytest.raises(ValueError, match="missing"):
        tfp.make_mixed_poisson(9, 9, 0.1, 0.1,
                               bcs_from_reference([j_dirichlet(0, "top")]))
    # the last BC writing a side wins, as in ns_tpu
    bcs = bcs_from_reference(j_cavity_p_bc(0.1, 0.2)
                             + [j_dirichlet(2.0, "left")])
    assert tfp._side_bcs(bcs) == jfp._side_bcs(bcs)
    assert tfp._side_bcs(bcs)["left"] == ("dirichlet", 2.0, 0.0)
