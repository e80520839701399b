"""Pressure-solve kernels: wrappers of K1, K2, K4, K5
(`csrc/poisson_kernels.cu`).

Each wrapper replaces a kernel of `ns_tpu/ops/pallas/poisson_kernels.py`
and keeps a plain twin:
  K2 `jacobi_fused`            <- `jacobi_fused_pallas`;
                                  twin `ops.poisson.jacobi` + `apply_bcs`
  K2 `jacobi_multiblock`       <- the same, beyond one block (the grids where
                                  the JAX package runs its XLA Jacobi; tiles
                                  with a halo, `jacobi_resident_plan`); same
                                  twin
  K1 `sor_redblack_fused`      <- `sor_redblack_fused_pallas`;
                                  twin `ops.poisson.sor_redblack`
  K4 `sor_redblack_packed_multiblock`
                               <- `sor_redblack_packed_tiled_pallas`, with
                                  `pack_redblack`/`unpack_redblack` (here,
                                  plain torch); twin
                                  `sor_redblack_packed_tiled` (here)
  K5 `sor_redblack_multiblock` <- `sor_redblack_tiled_pallas` and its
                                  entry `sor_redblack_tiled_any`;
                                  twin `sor_redblack_tiled` (here)

Each wrapper calls its operator in `torch.ops.ns_tpu` (`library.py`), and
the dispatcher picks the implementation by the tensors' device: on a CPU
tensor the plain twin (`_*_cpu` here), on a CUDA tensor the kernel
(`_*_cuda`), which launches or raises; nothing falls back. A BC list
enters the operators as its edge plan (`edge_plan`, 12 numbers). Each
wrapper counts its kernel launches in a `launches` attribute and its calls
that launched in `calls` (the group routes of K2mb, K4 and K5 launch once
per group; their resident routes count their solves in
`launches_resident` too). The SOR wrappers (K1, K4, K5) also count the
sweeps their solves ran and their member-solves (`sweep_counts`, below).

Every wrapper takes one (nx, ny) field or a (B, nx, ny) batch of members,
as the JAX package's FD ensemble gives its kernels under vmap. K1 and K2
run a batch in one launch, one block a member, K1 with each member's own
gate (one launch and one call a batch). K2mb, K4 and K5 already fill the
card with one member's tiles, so they solve the members in turn, each
member's launches counted, one call a batch. Their twins take the same
shapes: `ops.poisson.sor_redblack` gates each member on its own, the
tiled twins solve the members in turn.

What bounds each kernel on the H100, and how the design answers it, is in
the CUDA source's header. In short:
- K1 and K2 keep the whole grid in one block's shared memory and run every
  sweep (and K1's convergence gate) in one launch: at the reference sizes
  a solve is a chain of dependent sweeps, latency-bound. Both give each
  thread fixed cells (offsets found once: `k1_layout`; K2's interior list),
  so the sweep loop has no division. K1 keeps p as packed colour planes and
  publishes the gate through the colour barriers: two barriers a sweep. K2
  applies its BC list as an edge plan (`k2_edge_plan`) inside the sweep:
  one barrier a sweep.
- K2mb, K4 and K5 run a whole solve in one cooperative launch where their
  tile plan (`jacobi_resident_plan`; `resident_plan`, any ny) puts one
  block on each SM with its tile resident in shared memory (K4 and K5: of
  the packed planes): k sweeps a group there, each cut to the dependency
  cone, an exchange of own cells through L2 and a grid barrier (K4 and K5
  then read the gate on the device; K2mb runs a fixed nit). Grids too
  large for the card's shared memory keep one launch per group: K2mb on
  the same tiles with no host read, K4 on packed tiles and K5 as colour
  half-sweeps over the whole grid (`_color_groups`), both with the host
  gate.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import NamedTuple

import torch

from ns_tpu_torch.core.bc import BC, apply_bcs
from ns_tpu_torch.ops import poisson
from ns_tpu_torch.ops.kernels import _build

# Shared memory one Hopper block may opt into (227 KB), less 1 KB for the
# kernels' static reduction scratch.
SMEM_BUDGET = 227 * 1024 - 1024
# the H100's shared memory per block (opt-in), and its SMs
H100_SMEM_PER_BLOCK = 232448
H100_SMS = 132


def smem_fits(nx: int, ny: int, n_arrays: int = 2, itemsize: int = 4) -> bool:
    """True when `n_arrays` (nx, ny) grids of `itemsize` bytes fit one
    block's shared memory (the counterpart of the TPU kernels' vmem_fits).
    K1 holds p and rhs_c, K2 its ping-pong pair: two grids each."""
    return nx * ny * n_arrays * itemsize <= SMEM_BUDGET


def _consts(dx: float, dy: float):
    dx2, dy2 = dx * dx, dy * dy
    return dx2, dy2, 2.0 * (dx2 + dy2)


# --- K2: the edge plan ---------------------------------------------------------
#
# After a Jacobi sweep the BC list, applied in order, leaves on each side's
# non-corner cells what the side's last BC writes (its term, or the swept
# interior cell next to it plus its term: no other BC touches them), and on
# each corner what the last BC of its two sides writes, read from the edge
# cell next to it as the list left it. K2 applies this plan instead of the
# list (csrc/poisson_kernels.cu::jacobi_fused_kernel).

SIDES = _build.SIDES
# the corners (0,0), (0,ny-1), (nx-1,0), (nx-1,ny-1) and their two sides
CORNERS = (("left", "bottom"), ("left", "top"), ("right", "bottom"),
           ("right", "top"))


class K2EdgePlan(NamedTuple):
    kind: tuple[int, ...]      # per side: its last BC's kind (-1 none, 0
    #                            Dirichlet, 1 Neumann)
    term: tuple[float, ...]    # per side: that BC's edge term
    corner: tuple[int, ...]    # per corner: the side (index in SIDES) whose
    #                            BC writes it last, or -1

    def flat(self) -> tuple[float, ...]:
        """The 12 numbers K2's C entry unpacks: kind, corner, term."""
        return tuple(float(x) for x in (*self.kind, *self.corner,
                                        *self.term))


def k2_edge_plan(bcs) -> K2EdgePlan:
    """The edge plan of a BC list (see above)."""
    last = {bc.side: q for q, bc in enumerate(bcs)}
    kind = tuple(_build.KIND[bcs[last[s]].kind] if s in last else -1
                 for s in SIDES)
    term = tuple(bcs[last[s]].edge_term() if s in last else 0.0
                 for s in SIDES)
    corner = tuple(
        max((SIDES.index(s) for s in pair if s in last),
            key=lambda i: last[SIDES[i]], default=-1)
        for pair in CORNERS)
    return K2EdgePlan(kind, term, corner)


@functools.lru_cache(maxsize=64)
def edge_plan(bcs: tuple) -> tuple[float, ...]:
    """The edge plan of a BC list as the operators take it (`float[]`),
    built once per list: the solvers pass the same list every step, and a
    50^2 step is host-bound, so the plan is not rebuilt on every call."""
    return k2_edge_plan(bcs).flat()


@functools.lru_cache(maxsize=64)
def plan_spec(plan: tuple) -> ctypes.Array:
    """An edge plan (or K3's two) in the C entry's layout, built once per
    plan. The C entry only reads the array."""
    return (ctypes.c_double * len(plan))(*plan)


def _plan_bc(kind: float, side: str, term: float) -> BC:
    """A BC whose `edge_term()` is `term` exactly: a Dirichlet value, or a
    Neumann gradient over a spacing of 1 (signed as `edge_term` signs it)."""
    if kind == 0:
        return BC("dirichlet", term, side)
    return BC("neumann", term if side in ("right", "top") else -term, side,
              1.0, 1.0)


@functools.lru_cache(maxsize=64)
def plan_bcs(plan: tuple) -> tuple[BC, ...]:
    """A BC list with the edge plan `plan`: one BC a side the plan writes,
    with the plan's kind and edge term, in an order where each corner's
    writer comes after the other side of that corner. `apply_bcs` of it
    is `apply_bcs` of any list with this plan, bitwise (the plan is all
    that the list leaves on the edges, `test_torch_kernel_ops.py`); the
    operators' CPU twins apply it."""
    kind, corner, term = plan[:4], plan[4:8], plan[8:]
    sides = [s for s in range(4) if kind[s] >= 0]
    after = [(int(w), SIDES.index(o)) for c, w in enumerate(corner)
             if w >= 0 for o in CORNERS[c] if o != SIDES[int(w)]]
    for order in itertools.permutations(sides):
        pos = {s: n for n, s in enumerate(order)}
        if all(w in pos and pos[w] > pos.get(o, -1) for w, o in after):
            return tuple(_plan_bc(kind[s], SIDES[s], term[s]) for s in order)
    raise ValueError(f"no BC list has the edge plan {plan}")


def _new(out: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """out, or a copy of it where a twin returned its input as it was (no
    sweep ran): an operator's output never aliases an input."""
    return out.clone() if out is p else out


def jacobi_fused(p: torch.Tensor, b: torch.Tensor, dx: float, dy: float,
                 n_iter: int, p_bc) -> torch.Tensor:
    """All `n_iter` Jacobi sweeps, each followed by the p BC list in list
    order (direct_fd's pressure), in one launch of one block (K2), which
    applies the list as its edge plan (`k2_edge_plan`). A (B, nx, ny)
    batch is one launch, one block a member."""
    return torch.ops.ns_tpu.jacobi_fused.default(
        p, b, float(dx), float(dy), int(n_iter), edge_plan(tuple(p_bc)))


def _jacobi_cpu(p, b, dx, dy, n_iter, p_plan) -> torch.Tensor:
    """The twin of K2 and K2mb: `poisson.jacobi` with the BC list of the
    edge plan applied after each sweep."""
    bcs = plan_bcs(tuple(p_plan))
    return _new(poisson.jacobi(p, b, dx, dy, n_iter,
                               bc_fn=lambda q: apply_bcs(q, bcs)), p)


def _jacobi_fused_cuda(p, b, dx, dy, n_iter, p_plan) -> torch.Tensor:
    n, nx, ny = _build.check_inputs("jacobi_fused", p, b, members=True)
    if not smem_fits(nx, ny, 2, p.element_size()):
        raise ValueError(f"jacobi_fused: a {nx}x{ny} {p.dtype} grid does not "
                         "fit one block's shared memory")
    dx2, dy2, denom = _consts(dx, dy)
    out = torch.empty_like(p)
    spec = plan_spec(tuple(p_plan))
    fn = _build.entry("ns_jacobi_fused", p.dtype)
    with torch.cuda.device(p.device):
        code = fn(p.data_ptr(), b.data_ptr(), out.data_ptr(), nx, ny,
                  int(n_iter), dx2, dy2, denom, dx2 * dy2 / denom, spec, n,
                  nx * ny, _build.stream(p.device))
    _build.check(code, "jacobi_fused")
    jacobi_fused.launches += 1
    jacobi_fused.calls += 1
    return out


jacobi_fused.launches = 0
jacobi_fused.calls = 0


# --- K2 beyond one block: the tile plan -----------------------------------------
#
# K2's multi-block form (csrc/poisson_kernels.cu::jacobi_tiled_kernel) gives
# each block a tile of the grid, boundary cells included, and a halo of k
# cells (the reach of k sweeps) in shared memory, one warp a working row.
# A group of k sweeps then runs there, each cut to the dependency cone, with
# the edge plan inside; corners are written by their owner after the last
# sweep.

JACOBI_K = 8  # sweeps per group: the halo's width
# own-tile sides (rows, columns) the plan chooses among; 32m - 16 columns
# keep the cone's widest rows (own + 2(k - 1)) within m warp passes
JACOBI_ROWS = (16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 192, 256)
JACOBI_COLS = (32, 48, 64, 80, 96, 112, 128, 144, 176, 208, 240, 256)


class JacobiPlan(NamedTuple):
    tile_rows: int      # own rows of a block's tile
    tile_cols: int      # own columns
    grid_rows: int      # tiles down the grid (blockIdx.y)
    grid_cols: int      # tiles across (blockIdx.x)
    k: int              # sweeps per group
    c_in_smem: bool     # cb * b's working tile in shared memory too
    resident: bool      # one cooperative launch a solve, else one a group
    smem_bytes: int     # shared memory of one block

    @property
    def blocks(self) -> int:
        return self.grid_rows * self.grid_cols

    @property
    def working(self) -> tuple[int, int]:
        """A block's working tile: own cells plus k cells of halo on each
        side."""
        return self.tile_rows + 2 * self.k, self.tile_cols + 2 * self.k


def jacobi_group_cost(rows: int, cols: int, k: int) -> int:
    """Warp passes (32 lanes along a working row) of one tile's group of k
    sweeps, each cut to the cone: the sweep with r sweeps after it updates
    the own cells and r cells around them."""
    return sum((rows + 2 * r) * -(-(cols + 2 * r) // 32) for r in range(k))


def _jacobi_plan(nx: int, ny: int, itemsize: int, smem_per_block: int,
                 k: int, n_sms: int | None) -> JacobiPlan | None:
    """The cheapest tile plan: with `n_sms`, the resident route's (one
    block of 1024 threads on each SM at most: the group time of one tile,
    then the fewest blocks); without, the group route's (the total of all
    tiles). Every tile holds at least two rows and columns of the grid (a
    ragged last tile of one would own a corner without the edge cell next
    to it), and its ping-pong pair fits one block's shared memory (less 1
    KB); cb * b's tile joins it where all three fit."""
    budget = smem_per_block - 1024
    best = None
    for tr in JACOBI_ROWS:
        for tc in JACOBI_COLS:
            if nx % tr == 1 or ny % tc == 1:
                continue
            wr, wc = tr + 2 * k, tc + 2 * k
            blocks = -(-nx // tr) * -(-ny // tc)
            if 2 * wr * wc * itemsize > budget or (
                    n_sms is not None and blocks > n_sms):
                continue
            cost = jacobi_group_cost(min(tr, nx), min(tc, ny), k)
            key = ((cost if n_sms else blocks * cost), blocks, -tc)
            if best is None or key < best[0]:
                best = (key, tr, tc)
    if best is None:
        return None
    _, tr, tc = best
    cells = (tr + 2 * k) * (tc + 2 * k)
    c_smem = 3 * cells * itemsize <= budget
    return JacobiPlan(tr, tc, -(-nx // tr), -(-ny // tc), k, c_smem,
                      n_sms is not None, (3 if c_smem else 2) * cells
                      * itemsize)


def jacobi_resident_plan(nx: int, ny: int, itemsize: int,
                         n_sms: int = H100_SMS,
                         smem_per_block: int = H100_SMEM_PER_BLOCK,
                         k: int = JACOBI_K) -> JacobiPlan | None:
    """The tile plan of K2's resident route (one cooperative launch a
    solve), or None where no plan keeps every tile resident: at most
    `n_sms` tiles, each tile's working ping-pong pair in one block's shared
    memory. Of those, the one whose group of k cone-cut sweeps takes the
    fewest warp passes (all tiles run at once), then the fewest blocks,
    then the widest tile."""
    return _jacobi_plan(nx, ny, itemsize, smem_per_block, k, n_sms)


def jacobi_group_plan(nx: int, ny: int, itemsize: int,
                      smem_per_block: int = H100_SMEM_PER_BLOCK,
                      k: int = JACOBI_K) -> JacobiPlan:
    """The tile plan of K2's group route (one launch a group of k sweeps,
    for grids no resident plan holds): the fewest warp passes over all
    tiles."""
    return _jacobi_plan(nx, ny, itemsize, smem_per_block, k, None)


def jacobi_groups(n_iter: int, k: int) -> int:
    """Launches of the group route: one a group of k sweeps, and one copy
    at n_iter = 0."""
    return max(1, -(-n_iter // k))


@functools.cache
def _jacobi_card_plan(device: torch.device, nx: int, ny: int,
                      dtype: torch.dtype) -> JacobiPlan:
    """`jacobi_resident_plan` with this card's SMs and shared memory,
    checked against the kernel's own occupancy; where none exists, the
    group route's plan."""
    props = torch.cuda.get_device_properties(device)
    smem = getattr(props, "shared_memory_per_block_optin",
                   H100_SMEM_PER_BLOCK)
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = jacobi_resident_plan(nx, ny, itemsize, props.multi_processor_count,
                                smem)
    if plan is None:
        return jacobi_group_plan(nx, ny, itemsize, smem)
    per_sm = ctypes.c_int(0)
    fn = _build.entry("ns_jacobi_resident_occupancy", dtype)
    with torch.cuda.device(device):
        code = fn(plan.tile_rows, plan.tile_cols, plan.k,
                  int(plan.c_in_smem), ctypes.byref(per_sm))
    _build.check(code, "resident Jacobi occupancy")
    if per_sm.value * props.multi_processor_count < plan.blocks:
        raise RuntimeError(
            f"resident Jacobi: the plan {plan} needs {plan.blocks} resident "
            f"blocks, the card holds {per_sm.value} an SM")
    return plan


def jacobi_multiblock(p: torch.Tensor, b: torch.Tensor, dx: float, dy: float,
                      n_iter: int, p_bc) -> torch.Tensor:
    """`jacobi_fused` for any grid size (K2, multi-block form), bitwise
    equal to it on the grids both take: tiles of p with a halo of k cells
    in shared memory, k cone-cut sweeps a group with the edge plan inside,
    corners written by their owner after the last sweep.

    Resident route, where this card's tile plan exists
    (`jacobi_resident_plan`: 1024^2 and 1025^2 in both dtypes): the whole
    solve is one cooperative launch; between groups the blocks exchange
    their own cells through L2 and meet at a grid barrier. Counted in
    `launches` and `launches_resident`.

    Group route, for grids too large for the card's shared memory: one
    launch per group of k sweeps (`jacobi_groups`), between two device
    buffers. Neither route syncs with the host: nit is fixed.

    A (B, nx, ny) batch: the members in turn, one call."""
    return torch.ops.ns_tpu.jacobi_multiblock.default(
        p, b, float(dx), float(dy), int(n_iter), edge_plan(tuple(p_bc)))


def _jacobi_multiblock_cuda(p, b, dx, dy, n_iter, p_plan) -> torch.Tensor:
    _build.check_inputs("jacobi_multiblock", p, b, members=True)
    if n_iter < 0:
        raise ValueError(f"jacobi_multiblock: n_iter={n_iter}")
    out = poisson.solve_members(_jacobi_multiblock, p, b, dx, dy, n_iter,
                                tuple(p_plan))
    jacobi_multiblock.calls += 1
    return out


def _jacobi_multiblock(p, b, dx, dy, n_iter, p_plan) -> torch.Tensor:
    """One member's K2mb solve; counts its launches."""
    nx, ny = p.shape
    plan = _jacobi_card_plan(p.device, nx, ny, p.dtype)
    dx2, dy2, denom = _consts(dx, dy)
    out = torch.empty_like(p)
    if plan.resident:
        scratch = None
        xch = torch.empty((2, nx, ny), dtype=p.dtype, device=p.device)
        arrived = torch.empty(1, dtype=torch.int32, device=p.device)
    else:
        scratch, xch, arrived = torch.empty_like(p), None, None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _build.entry("ns_jacobi_multiblock", p.dtype)
    with torch.cuda.device(p.device):
        code = fn(p.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(scratch),
                  ptr(xch), ptr(arrived), nx, ny, plan.tile_rows,
                  plan.tile_cols, plan.k, int(plan.c_in_smem),
                  int(plan.resident), int(n_iter), dx2, dy2, denom,
                  dx2 * dy2 / denom, plan_spec(p_plan),
                  _build.stream(p.device))
    _build.check(code, "jacobi_multiblock")
    if plan.resident:
        jacobi_multiblock.launches += 1
        jacobi_multiblock.launches_resident += 1
    else:
        jacobi_multiblock.launches += jacobi_groups(int(n_iter), plan.k)
    return out


jacobi_multiblock.launches = 0
jacobi_multiblock.launches_resident = 0
jacobi_multiblock.calls = 0


# --- K1: one block, fixed cells per thread -----------------------------------
#
# The kernel lists each colour's interior cells in row-major order and gives
# thread t the entries t, t + 1024, ... of both lists. `k1_cells` mirrors
# its index arithmetic (csrc/poisson_kernels.cu::k1_cell).

K1_THREADS = 1024
# the kernel's instances: list entries a thread owns per colour (at most)
K1_CELLS_PER_THREAD = (1, 2, 4, 8, 16)


def k1_count(nx: int, ny: int, color: int) -> int:
    """Interior cells of colour `color` (0 red, (i+j) even; 1 black)."""
    return ((nx - 1) // 2 * ((ny - 1 - color) // 2)
            + (nx - 2) // 2 * ((ny - 2 + color) // 2))


def k1_cells(nx: int, ny: int, color: int, n: torch.Tensor):
    """(i, j) of the n-th interior cell of `color`, row-major: odd rows hold
    `a` cells from j = 1 + color, even rows `b` from j = 2 - color."""
    a, b = (ny - 1 - color) // 2, (ny - 2 + color) // 2
    pair, rem = n // (a + b), n % (a + b)
    odd_row = rem < a
    i = 2 * pair + torch.where(odd_row, 1, 2)
    j = (torch.where(odd_row, 1 + color, 2 - color)
         + 2 * torch.where(odd_row, rem, rem - a))
    return i, j


class K1Layout(NamedTuple):
    width: int               # packed plane columns, (ny + 1) // 2
    cells_per_thread: int    # the instance: list entries a thread owns
    rhs_in_registers: bool   # else rhs_c sits in shared memory
    smem_bytes: int


def k1_layout(nx: int, ny: int, itemsize: int) -> K1Layout:
    """The K1 instance the C entry picks for a grid (`sor_redblack_fused`
    in the CUDA source): the smallest cells-per-thread count that covers the
    larger colour, rhs_c in registers while a thread's share of both
    colours is at most 16 words."""
    most = max(k1_count(nx, ny, 0), k1_count(nx, ny, 1))
    per = -(-most // K1_THREADS)
    maxc = next((m for m in K1_CELLS_PER_THREAD if per <= m), None)
    if maxc is None:
        raise ValueError(f"K1: {nx}x{ny} needs {per} cells a thread")
    width = (ny + 1) // 2
    in_regs = 2 * maxc * itemsize <= 64
    cells = k1_count(nx, ny, 0) + k1_count(nx, ny, 1)
    smem = (2 * nx * width + (0 if in_regs else cells)) * itemsize
    return K1Layout(width, maxc, in_regs, smem)


def sor_redblack_fused(p: torch.Tensor, rhs_c: torch.Tensor, dx: float,
                       dy: float, beta: float, tol: float,
                       max_iter: int) -> torch.Tensor:
    """Red-black SOR to tolerance with the gate on the device: the whole
    chorin_fd pressure solve in one launch of one block (K1), p as packed
    colour planes in shared memory, each thread on fixed cells of each
    colour (`k1_layout`). A (B, nx, ny) batch is one launch, one block a
    member, each member stopped by its own gate."""
    return torch.ops.ns_tpu.sor_redblack_fused.default(
        p, rhs_c, float(dx), float(dy), float(beta), float(tol),
        int(max_iter))


def _sor_redblack_fused_cpu(p, rhs_c, dx, dy, beta, tol, max_iter):
    out, swept = poisson.sor_redblack_counted(p, rhs_c, dx, dy, beta, tol,
                                              max_iter)
    sor_redblack_fused.sweeps += int(swept.sum())
    sor_redblack_fused.solves += swept.numel()
    return _new(out, p)


def _sor_redblack_fused_cuda(p, rhs_c, dx, dy, beta, tol, max_iter):
    n, nx, ny = _build.check_inputs("sor_redblack_fused", p, rhs_c,
                                    members=True)
    if not smem_fits(nx, ny, 2, p.element_size()):
        raise ValueError(f"sor_redblack_fused: a {nx}x{ny} {p.dtype} grid "
                         "does not fit one block's shared memory; use "
                         "sor_redblack_multiblock")
    dx2, dy2, denom = _consts(dx, dy)
    out = torch.empty_like(p)
    fn = _build.entry("ns_sor_redblack_fused", p.dtype)
    with torch.cuda.device(p.device):
        code = fn(p.data_ptr(), rhs_c.data_ptr(), out.data_ptr(), nx, ny,
                  dx2, dy2, denom, float(beta), float(tol), int(max_iter), n,
                  nx * ny, _sweep_counter(p.device, sor_redblack_fused),
                  _build.stream(p.device))
    _build.check(code, "sor_redblack_fused")
    sor_redblack_fused.launches += 1
    sor_redblack_fused.calls += 1
    return out


sor_redblack_fused.launches = 0
sor_redblack_fused.calls = 0


def sor_redblack_tiled(p: torch.Tensor, rhs_c: torch.Tensor, dx: float,
                       dy: float, beta: float, tol: float, max_iter: int,
                       k: int = 8) -> torch.Tensor:
    """Plain twin of K5: the TPU tiled kernels' gate semantics on full-grid
    red-black sweeps. Groups of k sweeps run between gates; the gate reads
    the last sweep's max|dp|; err starts at inf and it at 1 and goes up by
    k, so the solve may run up to k-1 sweeps past `sor_redblack`'s stop.
    A (B, nx, ny) batch: the members in turn."""
    global _twin_swept
    if p.dim() == 3:
        return poisson.solve_members(sor_redblack_tiled, p, rhs_c, dx, dy,
                                     beta, tol, max_iter, k)
    masks = poisson.checkerboard(*p.shape, device=p.device)
    tol = poisson.dtype_float(tol, p.dtype)
    err, it = math.inf, 1
    while err > tol and it < max_iter:
        for _ in range(k - 1):
            p = poisson.redblack_sweep(p, rhs_c, dx, dy, beta, masks)
        p_new = poisson.redblack_sweep(p, rhs_c, dx, dy, beta, masks)
        err = float((p_new - p).abs().max())
        p, it = p_new, it + k
    _twin_swept += it - 1
    return p


def sor_redblack_multiblock(p: torch.Tensor, rhs_c: torch.Tensor, dx: float,
                            dy: float, beta: float, tol: float, max_iter: int,
                            k: int = 8) -> torch.Tensor:
    """Red-black SOR for grids beyond one block (K5), any shape, with
    `sor_redblack_tiled`'s iterate sequence and gate.

    Resident route, where this card's tile plan exists (`resident_plan`,
    odd ny included): K4's resident kernel on the packed colour planes,
    the whole solve one cooperative launch with the gate read on the
    device. Counted in `launches` and `launches_resident`.

    Beyond the card's shared memory: `_color_groups`, one launch per gate
    group and the gate read on the host.

    A (B, nx, ny) batch: the members in turn, one call."""
    return torch.ops.ns_tpu.sor_redblack_multiblock.default(
        p, rhs_c, float(dx), float(dy), float(beta), float(tol),
        int(max_iter), int(k))


def _sor_redblack_multiblock_cpu(p, rhs_c, dx, dy, beta, tol, max_iter, k):
    return _new(_count_twin(sor_redblack_multiblock, sor_redblack_tiled, p,
                            rhs_c, dx, dy, beta, tol, max_iter, k), p)


def _sor_redblack_multiblock_cuda(p, rhs_c, dx, dy, beta, tol, max_iter,
                                  k):
    _build.check_inputs("sor_redblack_multiblock", p, rhs_c, members=True)
    if k < 1:
        raise ValueError(f"sor_redblack_multiblock: k={k}")
    out = poisson.solve_members(_sor_multiblock, p, rhs_c, dx, dy, beta,
                                tol, max_iter, k)
    sor_redblack_multiblock.calls += 1
    return out


def _sor_multiblock(p, rhs_c, dx, dy, beta, tol, max_iter, k):
    """One member's K5 solve; counts its launches."""
    nx, ny = p.shape
    plan = _card_plan(p.device, nx, ny, p.dtype, k)
    if plan is None:
        return _color_groups(p, rhs_c, dx, dy, beta, tol, max_iter, k)
    out = _packed_resident(plan, p, rhs_c, dx, dy, beta, tol, max_iter,
                           sor_redblack_multiblock)
    sor_redblack_multiblock.launches += 1
    sor_redblack_multiblock.launches_resident += 1
    return out


def _color_groups(p, rhs_c, dx, dy, beta, tol, max_iter, k) -> torch.Tensor:
    """K5's route for any grid on a CUDA tensor: each launch of the C entry
    runs one group of k sweeps (2k colour half-sweep grids over the whole
    field) and leaves the last sweep's max|dp| in a device scalar; the host
    reads it once per group and applies `sor_redblack_tiled`'s gate. Each
    group counts in `sor_redblack_multiblock.launches`, the solve and its
    sweeps in its `solves` and `sweeps`."""
    nx, ny = _build.check_inputs("sor_redblack_multiblock", p, rhs_c)
    dx2, dy2, denom = _consts(dx, dy)
    q = p.clone()  # updated in place by the kernel
    err_buf = torch.empty(1, dtype=p.dtype, device=p.device)
    fn = _build.entry("ns_sor_redblack_tiled_group", p.dtype)
    tol = poisson.dtype_float(tol, p.dtype)
    err, it = math.inf, 1
    with torch.cuda.device(p.device):
        s = _build.stream(p.device)
        while err > tol and it < max_iter:
            code = fn(q.data_ptr(), rhs_c.data_ptr(), err_buf.data_ptr(), nx,
                      ny, dx2, dy2, denom, float(beta), int(k), s)
            _build.check(code, "sor_redblack_multiblock")
            sor_redblack_multiblock.launches += 1
            # the kernel max-reduces |dp| on its bit pattern, which for a
            # non-negative value reads back as the value itself
            err = float(err_buf.item())
            it += k
    sor_redblack_multiblock.sweeps += it - 1
    sor_redblack_multiblock.solves += 1
    return q


sor_redblack_multiblock.launches = 0
sor_redblack_multiblock.launches_resident = 0
sor_redblack_multiblock.calls = 0


# --- K4: packed red/black planes ---------------------------------------------
#
#   R[i, jc] = p[i, 2*jc + i%2]        (cells with (i+j) even)
#   B[i, jc] = p[i, 2*jc + (i+1)%2]    (cells with (i+j) odd)
#
# Up/down neighbours of either colour are the other colour at the same
# packed column (rows i+-1); the left/right pair is other[jc] plus
# other[jc-1] or other[jc+1]: red pairs even rows with jc-1 and odd rows
# with jc+1, black the opposite. The iterate sequence is the red-black
# sweeps' (`sor_redblack_tiled`).

# own packed cells (rows, columns) of one block of K4's group route; the
# halo is added around them (`packed_tile_bytes`)
PACKED_TILE = (64, 64)


def _rows_even(nx: int, device) -> torch.Tensor:
    return (torch.arange(nx, device=device) % 2 == 0)[:, None]


def pack_redblack(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(nx, ny) -> the packed colour planes (R, B), each (nx, ny/2)."""
    nx, ny = p.shape
    if ny % 2:
        raise ValueError(f"packed red-black planes need an even ny, got {ny}")
    rows_even = _rows_even(nx, p.device)
    even, odd = p[:, 0::2], p[:, 1::2]
    return torch.where(rows_even, even, odd), torch.where(rows_even, odd, even)


def unpack_redblack(R: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The (nx, 2 * ny2) grid of packed colour planes R, B."""
    nx, ny2 = R.shape
    rows_even = _rows_even(nx, R.device)
    even, odd = torch.where(rows_even, R, B), torch.where(rows_even, B, R)
    return torch.stack([even, odd], dim=2).reshape(nx, 2 * ny2)


def _packed_masks(nx: int, ny: int, device):
    """Interior masks of the R and B planes (by each cell's global j)."""
    ii = torch.arange(nx, device=device)[:, None]
    jc = torch.arange(ny // 2, device=device)[None, :]
    row_ok = (ii >= 1) & (ii <= nx - 2)
    jR = 2 * jc + ii % 2
    jB = 2 * jc + (ii + 1) % 2
    return (row_ok & (jR >= 1) & (jR <= ny - 2),
            row_ok & (jB >= 1) & (jB <= ny - 2))


def _packed_update(self_c, other, c, rows_even, red: bool, dx2, dy2, denom,
                   beta):
    """One colour's relaxation on its packed plane, in the TPU kernel's
    expression order (`color_update`)."""
    up = torch.roll(other, -1, 0)     # other[i+1, jc]
    down = torch.roll(other, 1, 0)    # other[i-1, jc]
    prev = torch.roll(other, 1, 1)    # other[i, jc-1]
    nxt = torch.roll(other, -1, 1)    # other[i, jc+1]
    shifted = (torch.where(rows_even, prev, nxt) if red
               else torch.where(rows_even, nxt, prev))
    lr = other + shifted
    return beta * (dy2 * (up + down) + dx2 * lr - c) / denom \
        + (1.0 - beta) * self_c


def sor_redblack_packed_tiled(p: torch.Tensor, rhs_c: torch.Tensor,
                              dx: float, dy: float, beta: float, tol: float,
                              max_iter: int, k: int = 8) -> torch.Tensor:
    """Plain twin of K4: full-grid red-black sweeps on the packed colour
    planes, with the TPU tiled kernels' gate (err starts at inf and it at
    1; each group runs k sweeps, it += k; the gate reads the last sweep's
    max|dp|). The iterate sequence is `sor_redblack_tiled`'s; ny must be
    even. A (B, nx, ny) batch: the members in turn."""
    global _twin_swept
    if p.dim() == 3:
        return poisson.solve_members(sor_redblack_packed_tiled, p, rhs_c,
                                     dx, dy, beta, tol, max_iter, k)
    nx, ny = p.shape
    R, B = pack_redblack(p)
    cR, cB = pack_redblack(rhs_c)
    maskR, maskB = _packed_masks(nx, ny, p.device)
    rows_even = _rows_even(nx, p.device)
    dx2, dy2, denom = _consts(dx, dy)

    def sweep(R, B):
        R = torch.where(maskR, _packed_update(R, B, cR, rows_even, True, dx2,
                                              dy2, denom, beta), R)
        B = torch.where(maskB, _packed_update(B, R, cB, rows_even, False, dx2,
                                              dy2, denom, beta), B)
        return R, B

    tol = poisson.dtype_float(tol, p.dtype)
    err, it = math.inf, 1
    while err > tol and it < max_iter:
        for _ in range(k - 1):
            R, B = sweep(R, B)
        Rn, Bn = sweep(R, B)
        err = float(torch.maximum((Rn - R).abs().max(), (Bn - B).abs().max()))
        R, B, it = Rn, Bn, it + k
    _twin_swept += it - 1
    return unpack_redblack(R, B)


def packed_tile_bytes(k: int, itemsize: int) -> int:
    """Shared memory of one block of K4's group route: the R and B planes
    of its tile, own cells plus a halo of 2k rows and k packed columns on
    each side (the reach of k red-black sweeps: one cell per colour
    half-sweep)."""
    rows, cols = PACKED_TILE
    return 2 * (rows + 4 * k) * (cols + 2 * k) * itemsize


# --- the resident route of K4 and K5: the tile plan ---------------------------

# own-tile sides (packed rows, packed columns) the plan chooses among
PLAN_ROWS = (16, 32, 48, 64, 96, 128, 192, 256)
PLAN_COLS = (16, 32, 48, 64, 96, 128)


class ResidentPlan(NamedTuple):
    tile_rows: int      # own packed rows of a block's tile
    tile_cols: int      # own packed columns
    grid_rows: int      # tiles down the grid (blockIdx.y)
    grid_cols: int      # tiles across (blockIdx.x)
    k: int              # sweeps per gate group
    c_in_smem: bool     # rhs_c's tile planes in shared memory too
    smem_bytes: int     # shared memory of one block

    @property
    def blocks(self) -> int:
        return self.grid_rows * self.grid_cols

    @property
    def working(self) -> tuple[int, int]:
        """A block's working tile: own cells plus 2k rows and k packed
        columns of halo on each side."""
        return self.tile_rows + 4 * self.k, self.tile_cols + 2 * self.k


def resident_plan(nx: int, ny: int, itemsize: int, n_sms: int = H100_SMS,
                  smem_per_block: int = H100_SMEM_PER_BLOCK,
                  k: int = 8) -> ResidentPlan | None:
    """The tile plan of the resident route of K4 and K5, or None where no
    plan keeps every tile resident: one block of 1024 threads on each SM
    (its 64 registers a thread fill the SM's register file), so at most
    `n_sms` tiles of the packed colour planes ((ny + 1) // 2 columns: at an
    odd ny one plane's last column in each row lies outside the grid), each
    tile's working R and B planes in one block's shared memory (less 1 KB).
    Of the plans that fit, the one with the fewest working cells a block
    (the time of a sweep, since all blocks run at once), then the fewest
    blocks, then the widest tile. rhs_c's tile planes join p's in shared
    memory where all four fit. The route's shape predicate is `plan is not
    None`."""
    ny2 = -(-ny // 2)
    budget = smem_per_block - 1024
    best = None
    for tr in PLAN_ROWS:
        for tc in PLAN_COLS:
            blocks = -(-nx // tr) * -(-ny2 // tc)
            wr, wc = tr + 4 * k, tc + 2 * k
            if blocks > n_sms or 2 * wr * wc * itemsize > budget:
                continue
            key = (wr * wc, blocks, -tc)
            if best is None or key < best[0]:
                best = (key, tr, tc)
    if best is None:
        return None
    _, tr, tc = best
    wr, wc = tr + 4 * k, tc + 2 * k
    c_smem = 4 * wr * wc * itemsize <= budget
    return ResidentPlan(tr, tc, -(-nx // tr), -(-ny2 // tc), k, c_smem,
                        (4 if c_smem else 2) * wr * wc * itemsize)


def gate_groups(max_iter: int, k: int) -> int:
    """Gate groups the TPU while_loop runs at most (it from 1, it += k,
    while it < max_iter): one error slot each."""
    return max(0, -(-(max_iter - 1) // k))


@functools.cache
def _card_plan(device: torch.device, nx: int, ny: int, dtype: torch.dtype,
               k: int) -> ResidentPlan | None:
    """`resident_plan` with this card's SMs and shared memory, checked
    against the kernel's own occupancy (blocks of 1024 threads an SM
    holds at the plan's shared memory)."""
    props = torch.cuda.get_device_properties(device)
    smem = getattr(props, "shared_memory_per_block_optin",
                   H100_SMEM_PER_BLOCK)
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = resident_plan(nx, ny, itemsize, props.multi_processor_count, smem,
                         k)
    if plan is None:
        return None
    per_sm = ctypes.c_int(0)
    fn = _build.entry("ns_sor_packed_resident_occupancy", dtype)
    with torch.cuda.device(device):
        code = fn(plan.tile_rows, plan.tile_cols, k, int(plan.c_in_smem),
                  ny % 2, ctypes.byref(per_sm))
    _build.check(code, "resident SOR occupancy")
    if per_sm.value * props.multi_processor_count < plan.blocks:
        raise RuntimeError(
            f"resident SOR: the plan {plan} needs "
            f"{plan.blocks} resident blocks, the card holds "
            f"{per_sm.value} an SM")
    return plan


def sor_redblack_packed_multiblock(p: torch.Tensor, rhs_c: torch.Tensor,
                                   dx: float, dy: float, beta: float,
                                   tol: float, max_iter: int,
                                   k: int = 8) -> torch.Tensor:
    """Red-black SOR on packed colour planes for grids beyond one block
    (K4), any shape with an even ny, with `sor_redblack_packed_tiled`'s
    iterate sequence and gate.

    Resident route, where this card's tile plan exists (`resident_plan`):
    the whole solve is one cooperative launch with no host read. Each
    block packs its tile of p (and rhs_c, where it fits) into shared memory
    as it loads it and keeps it there; per gate group it runs k sweeps,
    exchanges its own cells through an L2 buffer, meets the other blocks at
    a grid barrier and reads the group's error slot; the output is written
    unpacked. Counted in `launches` and `launches_resident`.

    Group route, for grids too large for the card's shared memory: each
    launch runs one gate group on 64x64 tiles of the packed planes
    (`pack_redblack` here) into the other buffers of a ping-pong pair, and
    the host reads the gate once per group.

    A (B, nx, ny) batch: the members in turn, one call."""
    return torch.ops.ns_tpu.sor_redblack_packed_multiblock.default(
        p, rhs_c, float(dx), float(dy), float(beta), float(tol),
        int(max_iter), int(k))


def _sor_redblack_packed_multiblock_cpu(p, rhs_c, dx, dy, beta, tol,
                                        max_iter, k):
    return _count_twin(sor_redblack_packed_multiblock,
                       sor_redblack_packed_tiled, p, rhs_c, dx, dy, beta, tol,
                       max_iter, k)


def _sor_redblack_packed_multiblock_cuda(p, rhs_c, dx, dy, beta, tol,
                                         max_iter, k):
    _, _, ny = _build.check_inputs("sor_redblack_packed_multiblock", p, rhs_c,
                                   members=True)
    if ny % 2:
        raise ValueError(f"packed red-black planes need an even ny, got {ny}")
    if k < 1:
        raise ValueError(f"sor_redblack_packed_multiblock: k={k}")
    out = poisson.solve_members(_packed_multiblock, p, rhs_c, dx, dy, beta,
                                tol, max_iter, k)
    sor_redblack_packed_multiblock.calls += 1
    return out


def _packed_multiblock(p, rhs_c, dx, dy, beta, tol, max_iter, k):
    """One member's K4 solve; counts its launches."""
    nx, ny = p.shape
    plan = _card_plan(p.device, nx, ny, p.dtype, k)
    if plan is None:
        return _packed_groups(p, rhs_c, dx, dy, beta, tol, max_iter, k)
    out = _packed_resident(plan, p, rhs_c, dx, dy, beta, tol, max_iter,
                           sor_redblack_packed_multiblock)
    sor_redblack_packed_multiblock.launches += 1
    sor_redblack_packed_multiblock.launches_resident += 1
    return out


def _packed_resident(plan: ResidentPlan, p, rhs_c, dx, dy, beta, tol,
                     max_iter, wrapper) -> torch.Tensor:
    """One launch of the resident kernel (K4's, and K5's where its plan
    exists); the caller counts the launch, the kernel the solve's sweeps
    (into `wrapper`'s pair)."""
    nx, ny = p.shape
    dx2, dy2, denom = _consts(dx, dy)
    out = torch.empty_like(p)
    xch = torch.empty((4, nx, -(-ny // 2)), dtype=p.dtype, device=p.device)
    n_slots = max(1, gate_groups(max_iter, plan.k))
    errs = torch.empty(n_slots, dtype=torch.int64, device=p.device)
    arrived = torch.empty(1, dtype=torch.int32, device=p.device)
    fn = _build.entry("ns_sor_redblack_packed_resident", p.dtype)
    with torch.cuda.device(p.device):
        code = fn(p.data_ptr(), rhs_c.data_ptr(), out.data_ptr(),
                  xch.data_ptr(), errs.data_ptr(), arrived.data_ptr(),
                  n_slots, nx, ny, plan.tile_rows, plan.tile_cols,
                  int(plan.c_in_smem), dx2, dy2, denom, float(beta),
                  float(tol), int(max_iter), plan.k,
                  _sweep_counter(p.device, wrapper), _build.stream(p.device))
    _build.check(code, "resident SOR")
    return out


def _packed_groups(p, rhs_c, dx, dy, beta, tol, max_iter, k) -> torch.Tensor:
    nx, ny = p.shape
    smem = packed_tile_bytes(k, p.element_size())
    if smem > SMEM_BUDGET:
        raise ValueError(f"sor_redblack_packed_multiblock: k={k} needs "
                         f"{smem} bytes of shared memory per block")
    dx2, dy2, denom = _consts(dx, dy)
    R, B = pack_redblack(p)
    R2, B2 = torch.empty_like(R), torch.empty_like(B)
    err_buf = torch.empty(1, dtype=p.dtype, device=p.device)
    fn = _build.entry("ns_sor_redblack_packed_group", p.dtype)
    tol = poisson.dtype_float(tol, p.dtype)
    rows, cols = PACKED_TILE
    err, it = math.inf, 1
    with torch.cuda.device(p.device):
        s = _build.stream(p.device)
        while err > tol and it < max_iter:
            code = fn(R.data_ptr(), B.data_ptr(), rhs_c.data_ptr(),
                      R2.data_ptr(), B2.data_ptr(), err_buf.data_ptr(), nx,
                      ny, rows, cols, dx2, dy2, denom, float(beta), int(k), s)
            _build.check(code, "sor_redblack_packed_multiblock")
            sor_redblack_packed_multiblock.launches += 1
            R, B, R2, B2 = R2, B2, R, B
            # max-reduced on the bit pattern, as in K5
            err = float(err_buf.item())
            it += k
    sor_redblack_packed_multiblock.sweeps += it - 1
    sor_redblack_packed_multiblock.solves += 1
    return unpack_redblack(R, B)


sor_redblack_packed_multiblock.launches = 0
sor_redblack_packed_multiblock.launches_resident = 0
sor_redblack_packed_multiblock.calls = 0


# --- the sweeps the SOR solves ran -------------------------------------------
#
# Each SOR wrapper counts, beside its launches, the sweeps its solves ran
# and its member-solves. On the card the one-block and resident kernels
# add a solve's sweeps (it - 1) and 1 into an int64 pair of the wrapper,
# one pair a wrapper in a persistent tensor a device, from one thread after
# the gate loop: no extra launch, no host read, and a CUDA-graph replay
# counts as the eager call did. The host-gated group routes and the CPU
# twins add theirs to the wrapper's `sweeps` and `solves` (the tiled twins
# through `_twin_swept`, so that their operators call them by name).

SWEPT = (sor_redblack_fused, sor_redblack_packed_multiblock,
         sor_redblack_multiblock)
_CARD_SWEEPS: dict[torch.device, torch.Tensor] = {}
_twin_swept = 0  # sweeps the tiled twins have run


def _sweep_counter(device: torch.device, wrapper) -> int:
    """The address of `wrapper`'s (sweeps, solves) pair on `device`, the
    device's pairs made at first use; 0 (nothing counted) where that use
    falls inside a CUDA-graph capture, which cannot allocate them."""
    acc = _CARD_SWEEPS.get(device)
    if acc is None:
        if torch.cuda.is_current_stream_capturing():
            return 0
        acc = _CARD_SWEEPS[device] = torch.zeros(
            (len(SWEPT), 2), dtype=torch.int64, device=device)
    return acc.data_ptr() + SWEPT.index(wrapper) * 2 * acc.element_size()


def _count_twin(wrapper, twin, p, *args) -> torch.Tensor:
    """`twin(p, *args)`, a tiled twin on a field or a batch, its sweeps and
    member-solves added to `wrapper`'s counts as its kernel counts them."""
    before = _twin_swept
    out = twin(p, *args)
    wrapper.sweeps += _twin_swept - before
    wrapper.solves += p.shape[0] if p.dim() == 3 else 1
    return out


def sweep_counts() -> dict[str, tuple[int, int]]:
    """(sweeps, member-solves) of each SOR wrapper since the last reset,
    the card's pairs read in one copy a device."""
    counts = {w.__name__: (w.sweeps, w.solves) for w in SWEPT}
    for acc in _CARD_SWEEPS.values():
        for w, (sweeps, solves) in zip(SWEPT, acc.tolist()):
            s, n = counts[w.__name__]
            counts[w.__name__] = (s + sweeps, n + solves)
    return counts


def reset_sweep_counts() -> None:
    for w in SWEPT:
        w.sweeps = w.solves = 0
    for acc in _CARD_SWEEPS.values():
        acc.zero_()


reset_sweep_counts()
