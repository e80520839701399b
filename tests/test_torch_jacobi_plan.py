"""K2's edge plan (csrc/poisson_kernels.cu::jacobi_fused_kernel) modelled in
plain torch on the CPU.

K2 does not apply the p BC list edge by edge after each Jacobi sweep: it
applies the list's edge plan (`k2_edge_plan`). The thread that sweeps an
interior cell next to an edge writes that edge cell in the same phase (the
side's last BC: its term, or the fresh interior cell plus its term), and
the corners, which no update reads, are written once after the last sweep
from the edge cells next to them (the last BC of their two sides). The
tests hold that plan against `apply_bcs` after a sweep, bitwise, for every
list built from the four sides x {absent, Dirichlet, Neumann} in several
orders and with repeated sides, and the kernel's whole schedule against
the twin `poisson.jacobi` + `apply_bcs`; then the twin against the JAX
kernel with BC lists other than the cavity's. Inputs are seeded numpy
arrays.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.ops.pallas.poisson_kernels import jacobi_fused_pallas
from ns_tpu_torch.core.bc import apply_bcs, bcs_from_reference
from ns_tpu_torch.ops import kernels, poisson
from ns_tpu_torch.ops.kernels import poisson_kernels as pk

GRIDS = [(3, 3), (3, 7), (6, 5), (50, 50)]
SIDES = pk.SIDES


def fields(seed, shape, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=shape)).to(dtype)
            for _ in range(2)]


def make_bc(kind, side, value, h, mod=None):
    """A BC of the port (`mod=None`) or of the JAX package."""
    if mod is None:
        return bcs_from_reference([make_bc(kind, side, value, h, "jax")])[0]
    if kind == "dirichlet":
        return j_dirichlet(value, side)
    return j_neumann(value, side, h, 1.5 * h)


def bc_lists(order: str, h: float):
    """Every assignment of {absent, Dirichlet, Neumann} to the four sides,
    as a list in the order `order` names: 'canonical' (left, right, bottom,
    top), 'reversed', or 'repeated' (rotated by the assignment's index,
    with one side given a second BC of the other kind, before or after its
    first)."""
    rng = np.random.default_rng(7)
    out = []
    for n, kinds in enumerate(itertools.product((None, "dirichlet",
                                                 "neumann"), repeat=4)):
        items = [(k, s) for k, s in zip(kinds, SIDES) if k is not None]
        if order == "reversed":
            items = items[::-1]
        elif order == "repeated":
            items = items[n % 4:] + items[:n % 4]
            if items:
                k, s = items[n % len(items)]
                other = "neumann" if k == "dirichlet" else "dirichlet"
                items.insert(0 if n % 2 else len(items), (other, s))
        out.append([make_bc(k, s, float(rng.normal()), h) for k, s in items])
    return out


def swept(p, b, h):
    """One Jacobi sweep of the interior with no BC (the boundary keeps its
    values), as the twin computes it."""
    return poisson.jacobi(p, b, h, h, 1)


def edge_cells(nx, ny):
    """(rows, cols) of each side's non-corner cells, and its inner
    neighbours' offsets, in SIDES order."""
    mid_r, mid_c = slice(1, nx - 1), slice(1, ny - 1)
    return [((0, mid_c), (1, 0)), ((nx - 1, mid_c), (-1, 0)),
            ((mid_r, 0), (0, 1)), ((mid_r, ny - 1), (0, -1))]


def apply_edges(q, plan, term):
    """The edge cells of a sweep as K2 writes them: each side's last BC,
    its term or the swept interior cell next to it plus its term."""
    nx, ny = q.shape
    for s, ((r, c), (di, dj)) in enumerate(edge_cells(nx, ny)):
        if plan.kind[s] == 0:
            q[r, c] = term[s]
        elif plan.kind[s] == 1:
            ri = r + di if isinstance(r, int) else slice(1 + di, nx - 1 + di)
            ci = c + dj if isinstance(c, int) else slice(1 + dj, ny - 1 + dj)
            q[r, c] = q[ri, ci] + term[s]


def apply_corners(q, plan, term):
    """The corners as K2 writes them after the last sweep: the last BC of
    their two sides, read from the edge cell next to them."""
    nx, ny = q.shape
    inner = [(1, 0), (-1, 0), (0, 1), (0, -1)]
    for c, (i, j) in enumerate(((0, 0), (0, ny - 1), (nx - 1, 0),
                                (nx - 1, ny - 1))):
        s = plan.corner[c]
        if s < 0:
            continue
        di, dj = inner[s]
        q[i, j] = term[s] if plan.kind[s] == 0 else q[i + di, j + dj] + term[s]


def terms(plan, dtype):
    """The plan's edge terms rounded to the field's dtype, as the kernel
    and the twin's scalar arithmetic round them."""
    return [torch.tensor(t, dtype=dtype) for t in plan.term]


@pytest.mark.parametrize("order", ["canonical", "reversed", "repeated"])
@pytest.mark.parametrize("shape", GRIDS)
def test_edge_plan_matches_apply_bcs_after_a_sweep(shape, order):
    """After one sweep, the edge plan (edges from the interior, then
    corners from the edges) leaves every cell as `apply_bcs` does, bitwise,
    for all 81 assignments of the four sides."""
    nx, ny = shape
    h = 2.0 / (nx - 1)
    p, b = fields(30, shape)
    q = swept(p, b, h)
    for bcs in bc_lists(order, h):
        plan = pk.k2_edge_plan(bcs)
        got = q.clone()
        t = terms(plan, q.dtype)
        apply_edges(got, plan, t)
        apply_corners(got, plan, t)
        assert torch.equal(got, apply_bcs(q, bcs)), bcs


def k2_model(p, b, h, n_iter, bcs):
    """K2's schedule: each sweep writes the interior and, from it, the edge
    cells; the corners only after the last sweep."""
    plan = pk.k2_edge_plan(bcs)
    t = terms(plan, p.dtype)
    for _ in range(n_iter):
        p = swept(p, b, h)
        apply_edges(p, plan, t)
    if n_iter:
        p = p.clone()
        apply_corners(p, plan, t)
    return p


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", GRIDS)
def test_k2_schedule_matches_twin(shape, dtype):
    """Corners written only after the last sweep change nothing: no update
    reads a corner. The model of K2's schedule equals the twin bitwise
    over 7 sweeps (and 0) for every 'repeated' list."""
    nx, ny = shape
    h = 2.0 / (nx - 1)
    p, b = fields(31, shape, dtype)
    for bcs in bc_lists("repeated", h):
        for n_iter in (0, 7):
            want = poisson.jacobi(p, b, h, h, n_iter,
                                  bc_fn=lambda q: apply_bcs(q, bcs))
            assert torch.equal(k2_model(p, b, h, n_iter, bcs), want), bcs


def test_edge_plan_layout():
    """The plan as the C entry unpacks it: kind[4], corner[4], term[4], in
    SIDES order; a side's entry is its last BC; a corner's is the side of
    the last BC among its two sides."""
    h = 0.5
    bcs = [make_bc("neumann", "left", 2.0, h),
           make_bc("dirichlet", "top", 3.0, h),
           make_bc("dirichlet", "left", 4.0, h),
           make_bc("neumann", "bottom", 1.0, h)]
    plan = pk.k2_edge_plan(bcs)
    assert plan.kind == (0, -1, 1, 0)
    assert plan.term == (4.0, 0.0, -0.75, 3.0)
    # (0,0): bottom after left; (0,ny-1): left after top; right has no BC
    assert plan.corner == (2, 0, 2, 3)
    assert list(plan.flat()) == [0, -1, 1, 0, 2, 0, 2, 3, 4.0, 0.0, -0.75,
                                 3.0]
    # the wrappers' cached plan is the same, and so is the C entry's array
    assert pk.edge_plan(tuple(bcs)) == plan.flat()
    assert list(pk.plan_spec(plan.flat())) == list(plan.flat())


@pytest.mark.parametrize("sides", [
    [("neumann", "left", 0.5), ("dirichlet", "right", 1.0),
     ("neumann", "top", -0.25), ("dirichlet", "bottom", 0.0)],
    [("dirichlet", "bottom", 2.0), ("neumann", "right", -1.0),
     ("neumann", "bottom", 0.3), ("dirichlet", "left", -0.5),
     ("neumann", "top", 0.7)]])
def test_twin_matches_jax_kernel_on_other_bc_lists(sides):
    """K2's twin against `jacobi_fused_pallas` (interpret mode) with BC
    lists other than the cavity's, one with a repeated side: <= 1e-12."""
    nx, ny = 24, 31
    h = 2.0 / (nx - 1)
    p0, b = fields(32, (nx, ny))
    jbcs = [make_bc(k, s, v, h, "jax") for k, s, v in sides]
    tbcs = bcs_from_reference(jbcs)
    want = np.asarray(jacobi_fused_pallas(
        jnp.asarray(p0.numpy()), jnp.asarray(b.numpy()), h, h, 25, jbcs,
        interpret=True))
    got = kernels.jacobi_fused(p0, b, h, h, 25, tbcs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
