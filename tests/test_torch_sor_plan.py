"""The index arithmetic of the redesigned K1, K4 and K5
(csrc/poisson_kernels.cu) modelled in plain torch on the CPU.

K1 gives each thread fixed interior cells of each colour; the model of its
cell list (`k1_cells`, the kernel's `k1_cell`) must cover every interior
cell of each colour exactly once. The resident route of K4 and K5 runs a
whole solve in one launch from a tile plan (`resident_plan`); the model
below runs the kernel's schedule on every tile of the plan at once (pack
on load, k sweeps on each working tile over the cells the own cells still
depend on, the per-group error slot and gate, the exchange of own cells
and the halo reload, the unpacked write) and must reproduce the plain
twins bitwise: `sor_redblack_packed_tiled` (K4, even ny) and
`sor_redblack_tiled` (K5, any ny: at an odd ny the packed planes have
(ny + 1) // 2 columns and one plane's last column in each row lies outside
the grid); and the JAX kernels where their shape predicates hold. Inputs
are seeded numpy arrays in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.ops.pallas.poisson_kernels import (
    sor_redblack_packed_tiled_pallas, sor_redblack_tiled_any)
from ns_tpu_torch.ops import kernels, poisson
from ns_tpu_torch.ops.kernels import poisson_kernels as pk


def fields(seed, shape, scale=(1.0, 1e-4)):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(s * rng.normal(size=shape)) for s in scale]


# --- K1 ------------------------------------------------------------------------

K1_SHAPES = [(3, 3), (3, 4), (4, 3), (5, 8), (6, 9), (17, 16), (51, 51),
             (64, 37), (120, 120), (121, 119), (170, 170), (169, 171),
             (3, 9642)]


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_cells_cover_each_interior_cell_once(shape):
    """Each colour's list entries 0 .. n-1 (thread t owns t, t + 1024, ...)
    are the interior cells of that colour, each exactly once, and a thread
    holds at most the instance's cells-per-thread of each colour."""
    nx, ny = shape
    red, black = poisson.checkerboard(nx, ny)
    layout = pk.k1_layout(nx, ny, 4)
    for color, mask in ((0, red), (1, black)):
        n = pk.k1_count(nx, ny, color)
        assert n == int(mask.sum())
        assert n <= layout.cells_per_thread * pk.K1_THREADS
        i, j = pk.k1_cells(nx, ny, color, torch.arange(n))
        hit = torch.zeros((nx, ny), dtype=torch.int64)
        hit.index_put_((i, j), torch.ones(n, dtype=torch.int64),
                       accumulate=True)
        assert torch.equal(hit, mask.to(torch.int64))
        # the kernel keeps (q << 1) | (j & 1) in 16 bits
        q = i * layout.width + (j >> 1)
        assert bool((((q << 1) | (j & 1)) < 1 << 16).all())


@pytest.mark.parametrize("shape,itemsize", [((51, 51), 4), ((51, 51), 8),
                                            ((170, 170), 4), ((120, 120), 8),
                                            ((3, 9642), 4), ((2, 14464), 4)])
def test_k1_layout_fits_the_grids_smem_fits_admits(shape, itemsize):
    """Every grid that `smem_fits` sends to K1 gets an instance whose
    packed planes (and rhs_c list, when it leaves registers) fit one
    block; 51^2 keeps rhs_c in registers, 170^2 fp32 in shared memory."""
    nx, ny = shape
    if nx < 3:  # below K1's 3x3 minimum: only the fit is checked
        assert pk.smem_fits(nx, ny, 2, itemsize)
        return
    assert pk.smem_fits(nx, ny, 2, itemsize)
    layout = pk.k1_layout(nx, ny, itemsize)
    assert layout.smem_bytes <= pk.H100_SMEM_PER_BLOCK - 16
    assert layout.smem_bytes <= nx * ny * 2 * itemsize
    if shape == (51, 51):
        assert layout.rhs_in_registers and layout.cells_per_thread == 2
    if shape == (170, 170):
        assert not layout.rhs_in_registers
        assert layout.cells_per_thread == 16


# --- the resident route of K4 and K5 ------------------------------------------

def resident_model(p, rhs, dx, dy, beta, tol, max_iter, plan):
    """The resident kernel on every tile of `plan` at once: (tiles, wr,
    wc) working planes. Returns the unpacked result and the per-group
    error slots that the gate read."""
    nx, ny = p.shape
    ny2, k = -(-ny // 2), plan.k
    hr, hc = 2 * k, k
    wr, wc = plan.working
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 * (dx2 + dy2)
    tiles = [(ty, tx) for ty in range(plan.grid_rows)
             for tx in range(plan.grid_cols)]
    r0 = torch.tensor([ty * plan.tile_rows - hr for ty, _ in tiles])
    c0 = torch.tensor([tx * plan.tile_cols - hc for _, tx in tiles])
    rows = (r0[:, None] + torch.arange(wr))[:, :, None]      # (T, wr, 1)
    cols = (c0[:, None] + torch.arange(wc))[:, None, :]      # (T, 1, wc)
    r = torch.arange(wr)[None, :, None]
    c = torch.arange(wc)[None, None, :]
    in_grid = (rows >= 0) & (rows < nx) & (cols >= 0) & (cols < ny2)
    own = (in_grid & (r >= hr) & (r < hr + plan.tile_rows)
           & (c >= hc) & (c < hc + plan.tile_cols))
    ri, ci = rows.clamp(0, nx - 1), cols.clamp(0, ny2 - 1)
    even_row = rows % 2 == 0

    pair = 2 * ci + 1 < ny  # the odd column j = 2jc + 1 lies in the grid

    def load_packed(f):
        """Pack on load: R = p[i, 2jc + i%2], B the other of the pair (0
        where j = ny, outside an odd-width grid)."""
        zero = torch.zeros((), dtype=f.dtype)
        a = f[ri, 2 * ci]
        b = torch.where(pair, f[ri, (2 * ci + 1).clamp(max=ny - 1)], zero)
        return (torch.where(in_grid, torch.where(even_row, a, b), zero),
                torch.where(in_grid, torch.where(even_row, b, a), zero))

    def valid(color):
        jpar = (rows + color) % 2
        j = 2 * cols + jpar
        cs = c + torch.where(jpar == 1, 1, -1)
        return (in_grid & (r >= 1) & (r <= wr - 2) & (rows >= 1)
                & (rows <= nx - 2) & (j >= 1) & (j <= ny - 2)
                & (cs >= 0) & (cs < wc)), jpar

    masks = [valid(0), valid(1)]

    def cone(reach):
        """What the own cells still depend on with `reach` half-sweeps left
        after this one: rows within reach, packed columns within
        (reach + 1) // 2 of the own tile (the kernel leaves the rest)."""
        e = (reach + 1) // 2
        return ((r >= hr - reach) & (r < hr + plan.tile_rows + reach)
                & (c >= hc - e) & (c < hc + plan.tile_cols + e))

    def half_sweep(self_c, other, c_tile, color, reach):
        mask, jpar = masks[color]
        mask = mask & cone(reach)
        up = torch.roll(other, -1, 1)
        down = torch.roll(other, 1, 1)
        shifted = torch.where(jpar == 1, torch.roll(other, -1, 2),
                              torch.roll(other, 1, 2))
        new = beta * (dy2 * (up + down) + dx2 * (other + shifted) - c_tile) \
            / denom + (1.0 - beta) * self_c
        return torch.where(mask, new, self_c)

    R, B = load_packed(p)
    cR, cB = load_packed(rhs)
    XR = torch.zeros((nx, ny2), dtype=p.dtype)
    XB = torch.zeros_like(XR)
    tol = poisson.dtype_float(tol, p.dtype)
    errs, err, it = [], float("inf"), 1
    while err > tol and it < max_iter:
        for sweep in range(k):
            left = 2 * (k - 1 - sweep)  # half-sweeps after this sweep
            R0, B0 = R, B
            R = half_sweep(R, B, cR, 0, left + 1)
            B = half_sweep(B, R, cB, 1, left)
        dp = torch.maximum((R - R0).abs(), (B - B0).abs())
        errs.append(float(torch.where(own, dp, 0.0).max()))  # atomicMax
        XR[rows.expand_as(own)[own], cols.expand_as(own)[own]] = R[own]
        XB[rows.expand_as(own)[own], cols.expand_as(own)[own]] = B[own]
        err, it = errs[-1], it + k
        if err > tol and it < max_iter:  # halo ring from the exchange
            ring = in_grid & ~own
            R = torch.where(ring, XR[ri, ci], R)
            B = torch.where(ring, XB[ri, ci], B)
    out = torch.full_like(p, float("nan"))
    oi, oc = rows.expand_as(own)[own], cols.expand_as(own)[own]
    er = even_row.expand_as(own)[own]
    out[oi, 2 * oc] = torch.where(er, R[own], B[own])
    op = pair.expand_as(own)[own]  # the unpacked write skips j = ny
    out[oi[op], 2 * oc[op] + 1] = torch.where(er, B[own], R[own])[op]
    return out, errs


@pytest.mark.parametrize("shape,tol,cap", [
    ((67, 90), 0.0, 9), ((67, 90), 0.0, 33), ((67, 90), 1.2e-2, 400),
    ((257, 190), 0.0, 9), ((257, 190), 0.0, 33), ((257, 190), 0.15, 400)])
def test_resident_schedule_matches_packed_twin(shape, tol, cap):
    """Ragged edge tiles: the resident schedule on the H100 plan equals the
    twin bitwise and runs the JAX while_loop's gate groups (all of them at
    tol 0; a tol that stops mid-way stops both at the same group)."""
    nx, ny = shape
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, rhs = fields(20, shape)
    plan = pk.resident_plan(nx, ny, 8)
    assert plan is not None
    assert plan.grid_rows * plan.tile_rows >= nx
    assert plan.grid_cols * plan.tile_cols >= ny // 2
    got, errs = resident_model(p0, rhs, dx, dy, 1.25, tol, cap, plan)
    want = kernels.sor_redblack_packed_tiled(p0, rhs, dx, dy, 1.25, tol, cap)
    assert torch.equal(got, want)
    groups = pk.gate_groups(cap, plan.k)
    if tol == 0.0:
        assert len(errs) == groups
    else:
        assert 1 < len(errs) < groups
        assert errs[-1] <= tol < errs[-2]


def test_resident_schedule_at_1024_matches_packed_twin():
    """The 1024^2 plan (16 x 8 tiles of 64 x 64 packed cells) at cap 17:
    two gate groups, one halo exchange, bitwise equal to the twin."""
    n = 1024
    h = 2.0 / (n - 1)
    p0, rhs = fields(21, (n, n), scale=(1.0, h * h))
    plan = pk.resident_plan(n, n, 8)
    assert (plan.tile_rows, plan.tile_cols, plan.blocks) == (64, 64, 128)
    got, errs = resident_model(p0, rhs, h, h, 1.25, 0.0, 17, plan)
    assert len(errs) == 2
    want = kernels.sor_redblack_packed_tiled(p0, rhs, h, h, 1.25, 0.0, 17)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,tol,cap", [
    ((67, 91), 0.0, 9), ((67, 91), 0.0, 33), ((67, 91), 1.2e-2, 400),
    ((257, 191), 0.0, 9), ((257, 191), 0.0, 33), ((257, 191), 0.15, 400)])
def test_resident_schedule_at_odd_widths_matches_tiled_twin(shape, tol, cap):
    """K5's resident route at odd ny (ragged edge tiles, W = (ny + 1) // 2
    packed columns, guarded loads and stores) equals K5's twin
    `sor_redblack_tiled` bitwise and runs its gate groups (all at tol 0;
    a tol that stops mid-way stops both at the same group)."""
    nx, ny = shape
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, rhs = fields(23, shape)
    plan = pk.resident_plan(nx, ny, 8)
    assert plan is not None
    assert plan.grid_rows * plan.tile_rows >= nx
    assert plan.grid_cols * plan.tile_cols >= (ny + 1) // 2
    got, errs = resident_model(p0, rhs, dx, dy, 1.25, tol, cap, plan)
    want = kernels.sor_redblack_tiled(p0, rhs, dx, dy, 1.25, tol, cap)
    assert torch.equal(got, want)
    groups = pk.gate_groups(cap, plan.k)
    if tol == 0.0:
        assert len(errs) == groups
    else:
        assert 1 < len(errs) < groups
        assert errs[-1] <= tol < errs[-2]


def test_resident_schedule_at_1025_matches_tiled_twin():
    """The 1025^2 plan (11 x 11 tiles of 96 x 48 packed cells, the last
    row and column of tiles ragged) at cap 17: two gate groups, one halo
    exchange, bitwise equal to K5's twin."""
    n = 1025
    h = 2.0 / (n - 1)
    p0, rhs = fields(24, (n, n), scale=(1.0, h * h))
    plan = pk.resident_plan(n, n, 8)
    assert (plan.tile_rows, plan.tile_cols, plan.blocks) == (96, 48, 121)
    got, errs = resident_model(p0, rhs, h, h, 1.25, 0.0, 17, plan)
    assert len(errs) == 2
    want = kernels.sor_redblack_tiled(p0, rhs, h, h, 1.25, 0.0, 17)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tol,cap", [(0.0, 17), (2e-2, 400)])
def test_resident_schedule_matches_jax_tiled_any(tol, cap):
    """On an odd 67x91 grid, against the JAX pad-and-mask tiled kernel
    (k=8, tile_rows=32, interpret mode): the same expression order and
    gate, <= 1e-12."""
    nx, ny = 67, 91
    dx, dy = 2.0 / (nx - 1), 2.0 / (ny - 1)
    p0, rhs = fields(25, (nx, ny))
    want = np.asarray(sor_redblack_tiled_any(
        jnp.asarray(p0.numpy()), jnp.asarray(rhs.numpy()), dx, dy, 1.25, tol,
        cap, k_per_launch=8, tile_rows=32, interpret=True))
    got, _ = resident_model(p0, rhs, dx, dy, 1.25, tol, cap,
                            pk.resident_plan(nx, ny, 8))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("tol,cap", [(0.0, 17), (5e-2, 400)])
def test_resident_schedule_matches_jax_packed_kernel(tol, cap):
    """On 256x256, where the JAX packed kernel's predicate holds (k=8,
    tile_rows=128, interpret mode): the same expression order, <= 1e-12."""
    n = 256
    dx = dy = 2.0 / (n - 1)
    p0, rhs = fields(22, (n, n))
    want = np.asarray(sor_redblack_packed_tiled_pallas(
        jnp.asarray(p0.numpy()), jnp.asarray(rhs.numpy()), dx, dy, 1.25, tol,
        cap, k_per_launch=8, tile_rows=128, interpret=True))
    got, _ = resident_model(p0, rhs, dx, dy, 1.25, tol, cap,
                            pk.resident_plan(n, n, 8))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_resident_plan_holds_1024_on_the_h100(itemsize):
    """1024^2 is resident in float32 and float64 under the H100's limits
    (132 SMs, 232,448 bytes a block): one tile a block, at most one block
    an SM, rhs_c's tiles in shared memory only in float32."""
    plan = pk.resident_plan(1024, 1024, itemsize, n_sms=132,
                            smem_per_block=232448)
    assert plan is not None and plan.blocks <= 132
    assert plan.smem_bytes <= 232448 - 1024
    assert plan.c_in_smem == (itemsize == 4)
    assert plan.smem_bytes == (4 if plan.c_in_smem else 2) * \
        plan.working[0] * plan.working[1] * itemsize


def test_resident_plan_refuses_what_the_card_cannot_hold():
    """4096^2 float32 (64 MB of planes against 30 MB of shared memory on
    132 SMs) keeps the group route; odd widths have plans where they fit:
    1025^2 in both dtypes (rhs_c's tiles in shared memory only in
    float32), 4097^2 not."""
    assert pk.resident_plan(4096, 4096, 4) is None
    assert pk.resident_plan(4097, 4097, 4) is None
    for itemsize in (4, 8):
        plan = pk.resident_plan(1025, 1025, itemsize, n_sms=132,
                                smem_per_block=232448)
        assert plan is not None and plan.blocks <= 132
        assert plan.c_in_smem == (itemsize == 4)
        assert plan.smem_bytes <= 232448 - 1024
    assert pk.resident_plan(1024, 1023, 4) is not None
    assert pk.gate_groups(200, 8) == 25 and pk.gate_groups(17, 8) == 2
    assert pk.gate_groups(1, 8) == 0
