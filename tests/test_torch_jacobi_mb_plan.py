"""K2's multi-block form (csrc/poisson_kernels.cu::jacobi_tiled_kernel)
modelled in plain torch on the CPU.

The kernel gives each block a tile of the grid from a tile plan
(`jacobi_resident_plan`, or `jacobi_group_plan` beyond the card's shared
memory) with a halo of k cells, and runs groups of k sweeps on a ping-pong
pair of working tiles: each sweep updates only the interior cells within
reach of the own tile (the sweeps left in the group), the thread that
sweeps a cell next to an edge writes that edge cell by K2's edge plan
(`k2_edge_plan`), halo included; between groups the tiles exchange their
own cells, a short last group runs what is left of nit, and the tile that
owns a corner writes it once, after the last sweep. The model below runs
that schedule on every tile of the plan at once and must reproduce the
twin `poisson.jacobi` + `apply_bcs` bitwise; cells outside the grid hold
NaN, so a read of one would show. Then the plan's choices at the main
path's grids, and the twin against the JAX kernel with other BC lists.
Inputs are seeded numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.ops.pallas.poisson_kernels import jacobi_fused_pallas
from ns_tpu_torch.core.bc import apply_bcs, bcs_from_reference, dirichlet, \
    neumann
from ns_tpu_torch.ops import kernels, poisson
from ns_tpu_torch.ops.kernels import poisson_kernels as pk

K = pk.JACOBI_K


def fields(seed, shape, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(s * rng.normal(size=shape)).to(dtype)
            for s in (1.0, 10.0)]


def bc_lists(dx, dy):
    """The cavity's p list, and two lists with Neumann sides (one with a
    side given twice, one that leaves a side and two corners alone)."""
    return {
        "cavity": [dirichlet(0, "top"), neumann(0, "bottom", dx, dy),
                   neumann(0, "left", dx, dy), neumann(0, "right", dx, dy)],
        "repeated": [dirichlet(2.0, "bottom"), neumann(-1.0, "right", dx, dy),
                     neumann(0.3, "bottom", dx, dy), dirichlet(-0.5, "left"),
                     neumann(0.7, "top", dx, dy)],
        "three sides": [neumann(0.5, "left", dx, dy), dirichlet(1.0, "top"),
                        neumann(-0.25, "bottom", dx, dy)]}


def k2mb_model(p, b, dx, dy, n_iter, bcs, plan):
    """The tiled kernel on every tile of `plan` at once: (tiles, wr, wc)
    working arrays."""
    nx, ny = p.shape
    k = plan.k
    wr, wc = plan.working
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 * (dx2 + dy2)
    tiles = [(ty, tx) for ty in range(plan.grid_rows)
             for tx in range(plan.grid_cols)]
    r0 = torch.tensor([ty * plan.tile_rows - k for ty, _ in tiles])
    c0 = torch.tensor([tx * plan.tile_cols - k for _, tx in tiles])
    rows = (r0[:, None] + torch.arange(wr))[:, :, None]      # (T, wr, 1)
    cols = (c0[:, None] + torch.arange(wc))[:, None, :]      # (T, 1, wc)
    r = torch.arange(wr)[None, :, None]
    c = torch.arange(wc)[None, None, :]
    in_grid = (rows >= 0) & (rows < nx) & (cols >= 0) & (cols < ny)
    own = (in_grid & (r >= k) & (r < k + plan.tile_rows)
           & (c >= k) & (c < k + plan.tile_cols))
    ri, ci = rows.clamp(0, nx - 1), cols.clamp(0, ny - 1)
    nan = torch.tensor(float("nan"), dtype=p.dtype)
    interior = (rows >= 1) & (rows <= nx - 2) & (cols >= 1) & (cols <= ny - 2)

    def load(f):
        return torch.where(in_grid, f[ri, ci], nan)

    cur = load(p)
    nxt = cur.clone()
    cbb = load(dx2 * dy2 / denom * b)  # cb * b, rounded on its own
    edge = pk.k2_edge_plan(bcs)
    term = [torch.tensor(t, dtype=p.dtype) for t in edge.term]

    def cone(reach):
        return ((r >= k - reach) & (r < k + plan.tile_rows + reach)
                & (c >= k - reach) & (c < k + plan.tile_cols + reach))

    # per side: the interior cells next to it, and the shift from such a
    # cell to its edge cell (dim, step of torch.roll)
    sides = [(rows == 1, (1, -1)), (rows == nx - 2, (1, 1)),
             (cols == 1, (2, -1)), (cols == ny - 2, (2, 1))]
    xch = torch.full((nx, ny), float("nan"), dtype=p.dtype)
    groups = -(-n_iter // k)
    for g in range(groups):
        kg = min(k, n_iter - g * k)
        for s in range(kg):
            upd = interior & cone(kg - 1 - s)
            new = ((torch.roll(cur, -1, 2) + torch.roll(cur, 1, 2)) * dy2
                   + (torch.roll(cur, -1, 1) + torch.roll(cur, 1, 1)) * dx2
                   ) / denom - cbb
            nxt = torch.where(upd, new, nxt)
            for side, (next_to, (dim, step)) in enumerate(sides):
                if edge.kind[side] < 0:
                    continue
                at = torch.roll(upd & next_to, step, dim)
                val = (term[side] if edge.kind[side] == 0
                       else torch.roll(new, step, dim) + term[side])
                nxt = torch.where(at, val, nxt)
            cur, nxt = nxt, cur
        if g + 1 < groups:  # exchange own cells, reload the halo ring
            xch[rows.expand_as(own)[own], cols.expand_as(own)[own]] = cur[own]
            cur = torch.where(in_grid & ~own, xch[ri, ci], cur)
    if n_iter:  # each corner by its owner, from the edge cell next to it
        inner = [(1, 0), (-1, 0), (0, 1), (0, -1)]
        for m, (gi, gj) in enumerate(((0, 0), (0, ny - 1), (nx - 1, 0),
                                      (nx - 1, ny - 1))):
            side = edge.corner[m]
            if side < 0:
                continue
            t = gi // plan.tile_rows * plan.grid_cols + gj // plan.tile_cols
            lr, lc = gi - int(r0[t]), gj - int(c0[t])
            di, dj = inner[side]
            assert bool(own[t, lr + di, lc + dj])  # an own cell: final
            cur[t, lr, lc] = (term[side] if edge.kind[side] == 0
                              else cur[t, lr + di, lc + dj] + term[side])
    out = torch.full_like(p, float("nan"))
    out[rows.expand_as(own)[own], cols.expand_as(own)[own]] = cur[own]
    return out


def twin(p, b, dx, dy, n_iter, bcs):
    return poisson.jacobi(p, b, dx, dy, n_iter,
                          bc_fn=lambda q: apply_bcs(q, bcs))


@pytest.mark.parametrize("n_iter", [0, 1, K, K + 3])
@pytest.mark.parametrize("shape", [(67, 90), (257, 190), (1025, 1024)])
def test_resident_schedule_matches_twin(shape, n_iter):
    """The resident plan's schedule (ragged edge tiles; at nit = k + 3 a
    halo exchange and a short last group of 3) equals the twin bitwise
    for each list, corners included; nit = 0 copies p."""
    nx, ny = shape
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, b = fields(40, shape)
    plan = pk.jacobi_resident_plan(nx, ny, 8)
    assert plan is not None and plan.resident
    assert plan.grid_rows * plan.tile_rows >= nx
    assert plan.grid_cols * plan.tile_cols >= ny
    for name, bcs in bc_lists(dx, dy).items():
        got = k2mb_model(p0, b, dx, dy, n_iter, bcs, plan)
        assert torch.equal(got, twin(p0, b, dx, dy, n_iter, bcs)), name


@pytest.mark.parametrize("n_iter", [1, 2 * K + 5])
def test_schedule_float32_and_group_plan_match_twin(n_iter):
    """float32 on the resident plan, and the group route's plan (one launch
    a group: the same schedule, its halo reloaded from the last group's
    output), at 257x190: bitwise equal to the twin."""
    nx, ny = 257, 190
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    group = pk.jacobi_group_plan(nx, ny, 8)
    assert not group.resident and group.blocks > 1
    for dtype, plan in ((torch.float32, pk.jacobi_resident_plan(nx, ny, 4)),
                        (torch.float64, group)):
        p0, b = fields(41, (nx, ny), dtype)
        for name, bcs in bc_lists(dx, dy).items():
            got = k2mb_model(p0, b, dx, dy, n_iter, bcs, plan)
            assert torch.equal(got, twin(p0, b, dx, dy, n_iter, bcs)), name


def test_plan_at_the_main_path_grids():
    """1024^2 and 1025^2 are resident in both dtypes under the H100's
    limits (132 SMs, 232,448 bytes a block): 132 tiles of 48 x 176, cb * b
    in shared memory only in float32. 2048^2 and 4096^2 float32 are not (a
    ping-pong pair of 2048^2 alone is 32 MB, the card's shared memory 30
    MB) and take the group route. Every plan's tiles hold at least two
    rows and columns of the grid."""
    for n in (1024, 1025):
        for itemsize in (4, 8):
            plan = pk.jacobi_resident_plan(n, n, itemsize, n_sms=132,
                                           smem_per_block=232448)
            assert plan is not None and plan.resident
            assert (plan.tile_rows, plan.tile_cols, plan.blocks) == \
                (48, 176, 132)
            assert plan.working == (64, 192)
            assert plan.c_in_smem == (itemsize == 4)
            assert plan.smem_bytes == (3 if itemsize == 4 else 2) * \
                64 * 192 * itemsize
            assert plan.smem_bytes <= 232448 - 1024
    for n in (2048, 4096):
        assert pk.jacobi_resident_plan(n, n, 4) is None
        plan = pk.jacobi_group_plan(n, n, 4)
        assert not plan.resident and plan.smem_bytes <= 232448 - 1024
        assert n % plan.tile_rows != 1 and n % plan.tile_cols != 1
    assert pk.jacobi_groups(50, 8) == 7 and pk.jacobi_groups(0, 8) == 1
    # a ragged last tile of one row would own a corner alone: refused
    plan = pk.jacobi_resident_plan(1025, 1025, 4)
    assert 1025 % plan.tile_rows != 1 and 1025 % plan.tile_cols != 1
    assert 2 * 64 * 192 * 4 <= pk.H100_SMEM_PER_BLOCK
    assert pk.jacobi_group_cost(48, 176, 8) == 8 * 6 * 48 + 6 * 56


@pytest.mark.parametrize("sides", [
    [("neumann", "left", 0.5), ("dirichlet", "right", 1.0),
     ("neumann", "top", -0.25), ("neumann", "bottom", 0.0)],
    [("dirichlet", "bottom", 2.0), ("neumann", "right", -1.0),
     ("neumann", "bottom", 0.3), ("neumann", "top", 0.7)]])
def test_twin_matches_jax_kernel_at_40x36(sides):
    """K2mb's twin against `jacobi_fused_pallas` (interpret mode) on a grid
    the JAX kernel takes, with lists other than the cavity's: <= 1e-12;
    and the model of K2mb's schedule on its resident plan there."""
    nx, ny = 40, 36
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, b = fields(42, (nx, ny))
    jbcs = [j_dirichlet(v, s) if k == "dirichlet" else j_neumann(v, s, dx, dy)
            for k, s, v in sides]
    tbcs = bcs_from_reference(jbcs)
    want = np.asarray(jacobi_fused_pallas(
        jnp.asarray(p0.numpy()), jnp.asarray(b.numpy()), dx, dy, 20, jbcs,
        interpret=True))
    got = kernels.jacobi_multiblock(p0, b, dx, dy, 20, tbcs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    plan = pk.jacobi_resident_plan(nx, ny, 8)
    assert torch.equal(k2mb_model(p0, b, dx, dy, 20, tbcs, plan), got)
