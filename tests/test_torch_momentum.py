"""Port explicit-momentum predictor (K3's twin) against the JAX package's
fused Pallas kernel (interpret mode) and its XLA twin.

Inputs are numpy arrays from a seeded generator fed to both packages;
float64, <= 1e-12 (the same arithmetic per cell in both). K3 itself is
held against the twin on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.ops.pallas.momentum_kernels import (momentum_explicit_fused_any,
                                                momentum_explicit_fused_pallas)
from ns_tpu_torch.core.bc import bcs_from_reference
from ns_tpu_torch.ops import kernels


def cavity_uv_bcs():
    u_bc = [j_dirichlet(0, "left"), j_dirichlet(1, "right"),
            j_dirichlet(0, "top"), j_dirichlet(0, "bottom")]
    v_bc = [j_dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    return u_bc, v_bc


def neumann_uv_bcs(dx, dy):
    u_bc = [j_neumann(0.5, "left", dx, dy), j_dirichlet(1, "right"),
            j_neumann(-0.25, "top", dx, dy), j_dirichlet(0, "bottom")]
    v_bc = [j_neumann(0, "bottom", dx, dy), j_neumann(0.3, "top", dx, dy),
            j_dirichlet(0, "left"), j_neumann(-1.0, "right", dx, dy)]
    return u_bc, v_bc


def inputs(seed, nx, ny):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(nx, ny)) for _ in range(4)]


def port(arrs, dt, dx, dy, nu, u_bc, v_bc, quirk):
    t = [torch.as_tensor(a) for a in arrs]
    return kernels.momentum_explicit(*t, dt, dx, dy, nu,
                                     bcs_from_reference(u_bc),
                                     bcs_from_reference(v_bc), quirk)


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("bcs", ["cavity", "neumann"])
def test_momentum_twin_matches_jax_pallas(quirk, bcs):
    """Quirk and corrected stencils, Dirichlet and Neumann edges, across
    the Pallas kernel's strip seams (64^2, 16-row strips)."""
    nx = ny = 64
    dx = dy = 2.0 / (nx - 1)
    dt, nu = 1e-3, 0.1
    u_bc, v_bc = cavity_uv_bcs() if bcs == "cavity" else neumann_uv_bcs(dx, dy)
    arrs = inputs(0, nx, ny)
    want = momentum_explicit_fused_pallas(
        *map(jnp.asarray, arrs), dt, dx, dy, nu, u_bc, v_bc,
        quirk_compat=quirk, tile_rows=16, interpret=True)
    got = port(arrs, dt, dx, dy, nu, u_bc, v_bc, quirk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_momentum_twin_matches_jax_any_odd_grid():
    """The reference's own 51^2 grid with Neumann edges against the
    pad-and-mask entry."""
    nx = ny = 51
    dx = dy = 2.0 / (nx - 1)
    u_bc, v_bc = neumann_uv_bcs(dx, dy)
    arrs = inputs(2, nx, ny)
    want = momentum_explicit_fused_any(*map(jnp.asarray, arrs), 1e-3, dx, dy,
                                       0.1, u_bc, v_bc, tile_rows=16,
                                       interpret=True)
    got = port(arrs, 1e-3, dx, dy, 0.1, u_bc, v_bc, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_momentum_fused_takes_twin_on_cpu():
    kernels.reset_launch_counts()
    nx, ny = 12, 9
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    u_bc, v_bc = (bcs_from_reference(b) for b in neumann_uv_bcs(dx, dy))
    t = [torch.as_tensor(a) for a in inputs(3, nx, ny)]
    got = kernels.momentum_explicit_fused(*t, 1e-3, dx, dy, 0.1, u_bc, v_bc)
    want = kernels.momentum_explicit(*t, 1e-3, dx, dy, 0.1, u_bc, v_bc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.momentum_explicit_fused.launches == 0
