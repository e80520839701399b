"""K3's one-pass edge writes (csrc/momentum_kernels.cu::k3_boundary)
modelled in plain torch on the CPU.

K3 computes u* and v* in one launch: interior cells from the stencils, and
every boundary cell, by the thread that owns it, as the BC list leaves it,
read from the list's edge plan (`k2_edge_plan`): a side's non-corner cells
hold its last BC's term, or the fresh interior cell next to it plus that
term, or the input's value where the side has no BC; a corner holds what
the last BC of its two sides writes, read from the edge cell next to it,
which is itself that side's rule (term, input value, or the fresh diagonal
interior cell plus a term). The model below applies exactly those rules,
cell by cell from the fresh interior and the input, and must equal the
twin `momentum_explicit` bitwise for every list built from the four sides
x {absent, Dirichlet, Neumann} in three orders, quirk on and off. Then the
twin against the JAX any-shape kernel with the corrected stencil. Inputs
are seeded numpy arrays.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.ops.pallas.momentum_kernels import momentum_explicit_fused_any
from ns_tpu_torch.core.bc import bcs_from_reference
from ns_tpu_torch.ops import kernels
from ns_tpu_torch.ops.kernels import poisson_kernels as pk

SIDES = pk.SIDES
DT, NU = 1e-3, 0.1


def inputs(seed, shape, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=shape)).to(dtype)
            for _ in range(4)]


def bc_lists(order: str, h: float, seed: int):
    """Every assignment of {absent, Dirichlet, Neumann} to the four sides,
    in the order `order` names: 'canonical' (left, right, bottom, top),
    'reversed', or 'rotated' (by the assignment's index, with one side
    given a second BC of the other kind, before or after its first)."""
    rng = np.random.default_rng(seed)
    out = []
    for n, kinds in enumerate(itertools.product((None, "dirichlet",
                                                 "neumann"), repeat=4)):
        items = [(k, s) for k, s in zip(kinds, SIDES) if k is not None]
        if order == "reversed":
            items = items[::-1]
        elif order == "rotated":
            items = items[n % 4:] + items[:n % 4]
            if items:
                k, s = items[n % len(items)]
                other = "neumann" if k == "dirichlet" else "dirichlet"
                items.insert(0 if n % 2 else len(items), (other, s))
        jbcs = [j_dirichlet(float(rng.normal()), s) if k == "dirichlet"
                else j_neumann(float(rng.normal()), s, h, 1.5 * h)
                for k, s in items]
        out.append(bcs_from_reference(jbcs))
    return out


def one_pass(fresh, inp, bcs):
    """What K3's threads write for one field: the fresh interior, and each
    boundary cell by the plan's rule (k3_boundary), from the fresh interior
    and the input only."""
    plan = pk.k2_edge_plan(bcs)
    term = [torch.tensor(t, dtype=fresh.dtype) for t in plan.term]
    nx, ny = fresh.shape
    out = fresh.clone()
    mid_r, mid_c = slice(1, nx - 1), slice(1, ny - 1)
    # per side: its non-corner cells and the interior cells next to them
    cells = [((0, mid_c), (1, mid_c)), ((nx - 1, mid_c), (nx - 2, mid_c)),
             ((mid_r, 0), (mid_r, 1)), ((mid_r, ny - 1), (mid_r, ny - 2))]

    def rule(side, at, inner):
        if plan.kind[side] < 0:
            return inp[at]
        if plan.kind[side] == 0:
            return term[side]
        return fresh[inner] + term[side]

    for side, (at, inner) in enumerate(cells):
        out[at] = rule(side, at, inner)
    step = [(1, 0), (-1, 0), (0, 1), (0, -1)]  # a Neumann BC's read
    for m, (i, j) in enumerate(((0, 0), (0, ny - 1), (nx - 1, 0),
                                (nx - 1, ny - 1))):
        side = plan.corner[m]
        if side < 0:
            continue  # the input's value, as the fresh field holds it
        if plan.kind[side] == 0:
            out[i, j] = term[side]
            continue
        ai, aj = i + step[side][0], j + step[side][1]
        # the edge cell next to the corner lies on the corner's other side
        other = (2 if j == 0 else 3) if side <= 1 else (0 if i == 0 else 1)
        di, dj = step[other]
        out[i, j] = rule(other, (ai, aj), (ai + di, aj + dj)) + term[side]
    return out


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("order", ["canonical", "reversed", "rotated"])
@pytest.mark.parametrize("shape", [(3, 3), (3, 7), (6, 5), (51, 51)])
def test_one_pass_edges_match_twin(shape, order, quirk):
    """For all 81 side assignments: u* and v* cell by cell from the fresh
    interior and the input equal the twin (interior, then the lists in
    order) bitwise."""
    nx, ny = shape
    h = 2.0 / (nx - 1)
    f = inputs(50, shape)
    # the fresh interior, boundary cells holding the input's values
    fu, fv = kernels.momentum_explicit(*f, DT, h, h, NU, [], [], quirk)
    assert torch.equal(fu[0], f[0][0]) and torch.equal(fv[:, 0], f[1][:, 0])
    u_lists = bc_lists(order, h, 51)
    v_lists = bc_lists(order, h, 52)[::-1]
    for u_bc, v_bc in zip(u_lists, v_lists):
        want_u, want_v = kernels.momentum_explicit(*f, DT, h, h, NU, u_bc,
                                                   v_bc, quirk)
        assert torch.equal(one_pass(fu, f[0], u_bc), want_u), u_bc
        assert torch.equal(one_pass(fv, f[1], v_bc), want_v), v_bc


def test_one_pass_edges_match_twin_float32():
    """The same rules in float32 at 51^2 (terms rounded to float32 as the
    kernel and the twin round them), quirk on."""
    h = 2.0 / 50
    f = inputs(53, (51, 51), torch.float32)
    fu, fv = kernels.momentum_explicit(*f, DT, h, h, NU, [], [], True)
    for u_bc, v_bc in zip(bc_lists("rotated", h, 54),
                          bc_lists("reversed", h, 55)):
        want_u, want_v = kernels.momentum_explicit(*f, DT, h, h, NU, u_bc,
                                                   v_bc, True)
        assert torch.equal(one_pass(fu, f[0], u_bc), want_u)
        assert torch.equal(one_pass(fv, f[1], v_bc), want_v)


def test_twin_matches_jax_any_with_the_corrected_stencil():
    """The twin against `momentum_explicit_fused_any` (interpret mode) on
    an odd 37x23 grid with Neumann lists and quirk off: <= 1e-12 (the
    existing tests hold quirk on)."""
    nx, ny = 37, 23
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    u_bc = [j_neumann(0.5, "left", dx, dy), j_dirichlet(1, "right"),
            j_neumann(-0.25, "top", dx, dy), j_neumann(0.1, "bottom", dx, dy)]
    v_bc = [j_neumann(0, "bottom", dx, dy), j_neumann(0.3, "top", dx, dy),
            j_dirichlet(0, "left"), j_neumann(-1.0, "right", dx, dy)]
    arrs = [a.numpy() for a in inputs(56, (nx, ny))]
    want = momentum_explicit_fused_any(*map(jnp.asarray, arrs), DT, dx, dy,
                                       NU, u_bc, v_bc, quirk_compat=False,
                                       tile_rows=16, interpret=True)
    got = kernels.momentum_explicit_fused(
        *map(torch.as_tensor, arrs), DT, dx, dy, NU,
        bcs_from_reference(u_bc), bcs_from_reference(v_bc), False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
