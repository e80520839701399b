"""Port BCs (ns_tpu_torch.core.bc) against the JAX package's ns_tpu.core.bc.

Inputs come from numpy and go through both packages; edge writes are
compared EXACTLY (float64), over every side x kind and several list orders,
so the corner cells — where list order decides the value — are covered.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core import bc as jbc
from ns_tpu_torch.core import bc as tbc

SIDES = ("left", "right", "bottom", "top")


def _pair(kind, value, side, dx=0.3, dy=0.7):
    make_j = jbc.dirichlet if kind == "dirichlet" else jbc.neumann
    make_t = tbc.dirichlet if kind == "dirichlet" else tbc.neumann
    return make_j(value, side, dx, dy), make_t(value, side, dx, dy)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("kind", ["dirichlet", "neumann"])
def test_apply_bc_matches_jax_exactly(side, kind):
    a = np.random.default_rng(0).normal(size=(6, 7))
    jb, tb = _pair(kind, 1.7, side)
    want = np.asarray(jbc.apply_bc(jnp.asarray(a), jb))
    got = tbc.apply_bc(torch.as_tensor(a), tb).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", list(itertools.permutations(SIDES))[::5])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_bcs_list_order_and_corners_exact(order, seed):
    """Mixed Dirichlet/Neumann lists in several orders: later BCs overwrite
    corners, Neumann edges read the current inner neighbour."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(5, 8))
    kinds = rng.choice(["dirichlet", "neumann"], size=4)
    values = rng.normal(size=4)
    pairs = [_pair(k, float(v), s) for k, v, s in zip(kinds, values, order)]
    want = np.asarray(jbc.apply_bcs(jnp.asarray(a), [p[0] for p in pairs]))
    got = tbc.apply_bcs(torch.as_tensor(a), [p[1] for p in pairs]).numpy()
    np.testing.assert_array_equal(got, want)


def test_apply_bcs_leaves_input_untouched():
    a = torch.zeros((4, 4), dtype=torch.float64)
    out = tbc.apply_bcs(a, [tbc.dirichlet(1.0, "left")])
    assert float(a.abs().max()) == 0.0 and float(out[0].min()) == 1.0


def test_sequential_order_at_corners():
    a = torch.zeros((3, 3), dtype=torch.float64)
    out = tbc.apply_bcs(a, [tbc.dirichlet(1.0, "left"), tbc.dirichlet(2.0, "top")])
    assert out[0, -1] == 2.0
    out = tbc.apply_bcs(a, [tbc.dirichlet(2.0, "top"), tbc.dirichlet(1.0, "left")])
    assert out[0, -1] == 1.0


def test_bcs_from_reference_converts_jax_bcs():
    dx, dy = 0.1, 0.2
    ref = [jbc.dirichlet(0, "top"), jbc.neumann(0.5, "bottom", dx, dy),
           jbc.NeumannBoundaryCondition(-1.0, "left", dx, dy)]
    got = tbc.bcs_from_reference(ref)
    assert got == [tbc.dirichlet(0.0, "top"), tbc.neumann(0.5, "bottom", dx, dy),
                   tbc.neumann(-1.0, "left", dx, dy)]
    assert all(isinstance(b, tbc.BC) for b in got)


def test_reference_named_constructors_and_validation():
    d = tbc.DirichletBoundaryCondition(1.0, "top", 0.1, 0.1)
    assert d == tbc.dirichlet(1.0, "top", 0.1, 0.1)
    assert d.type == "dirichlet" and d.boundary == "top"
    n = tbc.NeumannBoundaryCondition(0.5, "left", 0.1, 0.2)
    assert n == tbc.neumann(0.5, "left", 0.1, 0.2)
    with pytest.raises(ValueError):
        tbc.BC("dirichlet", 0.0, "middle")
    with pytest.raises(ValueError):
        tbc.BC("robin", 0.0, "left")


def test_edge_term_signs():
    """The number the kernels receive: the value, or the signed Neumann
    offset (minus on left/bottom, plus on right/top)."""
    dx, dy, g = 0.5, 0.25, 2.0
    assert tbc.dirichlet(3.0, "left").edge_term() == 3.0
    assert tbc.neumann(g, "left", dx, dy).edge_term() == -dx * g
    assert tbc.neumann(g, "right", dx, dy).edge_term() == dx * g
    assert tbc.neumann(g, "bottom", dx, dy).edge_term() == -dy * g
    assert tbc.neumann(g, "top", dx, dy).edge_term() == dy * g
