"""The kernels' operators (`torch.ops.ns_tpu`, ns_tpu_torch/ops/kernels/
library.py) on the CPU, float64, at small sizes, inputs from seeded numpy
generators.

Each of the nine routes of `kernels.WRAPPERS` is one operator. Here each
passes `torch.library.opcheck` (schema, fake tensor, autograd
registration, AOT dispatch with dynamic shapes); its wrapper traces under
fake tensors into one node of that operator, with the output shapes the
twin gives; on CPU tensors the operator is the twin bitwise, also on
tensors that require grad. The BC list an operator's twin applies,
rebuilt from the edge plan (`plan_bcs`), equals the list it came from
bitwise for every list of the four sides x {absent, Dirichlet, Neumann}.
The gated loops of `ops/poisson.py` (cg, the wavefront SOR), now
`while_loop`s, are bitwise the Python loops they replaced, which are kept
here as the reference. On the card the operators launch the kernels
(`tests/test_torch_cuda.py`).
"""

import inspect
import itertools
import math

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from ns_tpu_torch.core.bc import BC, apply_bcs
from ns_tpu_torch.ops import kernels, poisson
from ns_tpu_torch.ops.kernels import library
from ns_tpu_torch.ops.kernels import momentum_kernels as mk
from ns_tpu_torch.ops.kernels import poisson_kernels as pk
from ns_tpu_torch.ops.kernels import transform3d_kernels as tk
from ns_tpu_torch.solvers import spectral3d as s3

NAMES = [w.__name__ for w in kernels.WRAPPERS.values()]


def field(rng, *shape):
    return torch.as_tensor(rng.normal(size=shape))


def bc_list(rng, h):
    return [BC("dirichlet", float(rng.normal()), "top"),
            BC("neumann", float(rng.normal()), "bottom", h, h),
            BC("neumann", float(rng.normal()), "left", h, h),
            BC("dirichlet", float(rng.normal()), "right"),
            BC("neumann", float(rng.normal()), "top", h, h)]


def tables(n=8):
    cfg = s3.Spectral3DConfig(nx=n, ny=n, nz=n, transform="matmul",
                              dtype="float64")
    return s3._dft_tables(cfg, "cpu")


def case(name, seed=0):
    """(wrapper arguments, operator arguments, twin) of one route on a
    small float64 input: the wrapper takes BC lists and tables as the
    solvers pass them, the operator their edge plans and tensors."""
    rng = np.random.default_rng(seed)
    h = 0.1
    if name in ("sor_redblack_fused", "sor_redblack_multiblock",
                "sor_redblack_packed_multiblock"):
        shape = (2, 16, 12) if name == "sor_redblack_packed_multiblock" \
            else (2, 15, 13)
        args = (field(rng, *shape), field(rng, *shape), h, 1.5 * h, 1.25,
                1e-6, 30)
        if name == "sor_redblack_fused":
            return args, args, poisson.sor_redblack
        twin = (pk.sor_redblack_tiled if name == "sor_redblack_multiblock"
                else pk.sor_redblack_packed_tiled)
        return args + (8,), args + (8,), twin
    if name in ("jacobi_fused", "jacobi_multiblock"):
        p_bc = bc_list(rng, h)
        p, b = field(rng, 2, 14, 11), field(rng, 2, 14, 11)
        plan = pk.edge_plan(tuple(p_bc))
        return ((p, b, h, h, 7, p_bc), (p, b, h, h, 7, plan),
                lambda p, b, dx, dy, n, bcs: poisson.jacobi(
                    p, b, dx, dy, n, bc_fn=lambda q: apply_bcs(q, bcs)))
    if name == "momentum_explicit_fused":
        u_bc, v_bc = bc_list(rng, h), bc_list(rng, h)[::-1]
        f = [field(rng, 2, 13, 17) for _ in range(4)]
        plans = (pk.edge_plan(tuple(u_bc)), pk.edge_plan(tuple(v_bc)))
        return ((*f, 1e-3, h, h, 0.1, u_bc, v_bc, True),
                (*f, 1e-3, h, h, 0.1, *plans, True), mk.momentum_explicit)
    M = tables()
    ry, kzc = M["Fy_t"].shape[0], M["Fz_t"].shape[0]
    if name == "fused_zy_forward":
        args = (field(rng, 2, 8, 8, 8), M["Fz_t"], M["Fy_t"], "highest")
        return args, args, tk.zy_forward
    a = torch.complex(field(rng, 6, 8, ry, kzc), field(rng, 6, 8, ry, kzc))
    if name == "fused_yz_inverse":
        args = (a[:2], M["Fyi_t"], M["Bz"], 8, "highest")
        return args, args, tk.yz_inverse
    args = (a, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"], 8, "highest")
    return args, args, tk.lamb


def op(name):
    return getattr(torch.ops.ns_tpu, name).default


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def test_one_operator_for_each_route():
    assert sorted(library.OPERATORS) == sorted(NAMES)
    for name in NAMES:
        schema = op(name)._schema
        assert str(schema).startswith(f"ns_tpu::{name}(")
        # outputs are new tensors: no alias, nothing mutated
        assert not any(a.alias_info for a in schema.arguments)
        assert not any(r.alias_info for r in schema.returns)


def test_no_wrapper_branches_on_the_device():
    """The dispatcher chooses kernel or twin: no module of ops/kernels
    tests a tensor's device type."""
    for mod in (mk, pk, tk, library):
        assert "device.type" not in inspect.getsource(mod), mod.__name__


@pytest.mark.parametrize("name", NAMES)
def test_opcheck_on_the_cpu(name):
    _, op_args, _ = case(name)
    torch.library.opcheck(op(name), op_args)


@pytest.mark.parametrize("name", NAMES)
def test_operator_is_the_twin_on_the_cpu(name):
    """The wrapper, its operator and the twin (on the BC lists as given)
    agree bitwise, also on inputs that require grad."""
    args, op_args, twin = case(name, seed=3)
    want = as_tuple(twin(*args))
    for got in (as_tuple(getattr(kernels, name)(*args)),
                as_tuple(op(name)(*op_args))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    grad = tuple(a.clone().requires_grad_(True)
                 if isinstance(a, torch.Tensor) and a.dtype.is_floating_point
                 else a for a in op_args)
    for g, w in zip(as_tuple(op(name)(*grad)), want):
        assert torch.equal(g.detach(), w)


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_traces_to_one_operator_node(name):
    """make_fx over fake tensors: the wrapper (edge plans, tables, any
    host gate of the route) is one node of its operator, whose output
    shapes and dtypes are the twin's."""
    args, _, twin = case(name)
    wrapper = getattr(kernels, name)
    pos = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]

    def call(*tensors):
        full = list(args)
        for i, t in zip(pos, tensors):
            full[i] = t
        return wrapper(*full)

    gm = make_fx(call, tracing_mode="fake")(*(args[i] for i in pos))
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"
             and "ns_tpu" in str(n.target)]
    assert [str(n.target) for n in nodes] == [f"ns_tpu.{name}.default"]
    want = as_tuple(twin(*args))
    vals = as_tuple(nodes[0].meta["val"])
    assert [(v.shape, v.dtype) for v in vals] == [(w.shape, w.dtype)
                                                  for w in want]


def test_fake_outputs_of_the_3d_routes_follow_the_input_dtype():
    """At float32, the card's dtype, the fakes of K6-K8 give the twins'
    shapes and float32 / complex64 (float64 inputs: the trace test)."""
    M = {k: v.to(torch.complex64) for k, v in tables().items()}
    ry, kzc = M["Fy_t"].shape[0], M["Fz_t"].shape[0]
    rng = np.random.default_rng(1)
    w = field(rng, 8, 8, 8).float()
    a = torch.complex(field(rng, 6, 8, ry, kzc),
                      field(rng, 6, 8, ry, kzc)).to(torch.complex64)
    calls = [("fused_zy_forward", (w, M["Fz_t"], M["Fy_t"], "default")),
             ("fused_yz_inverse", (a[0], M["Fyi_t"], M["Bz"], 8, "default")),
             ("fused_lamb", (a, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"],
                             8, "default"))]
    for name, args in calls:
        real = op(name)(*args)
        meta = library.OPERATORS[name][3](*(
            x.to("meta") if isinstance(x, torch.Tensor) else x
            for x in args))
        assert (meta.shape, meta.dtype) == (real.shape, real.dtype), name
        assert real.dtype in (torch.float32, torch.complex64)


SIDES = ("left", "right", "bottom", "top")


def bc_lists(order):
    """Every assignment of {absent, Dirichlet, Neumann} to the four sides,
    in SIDES order, reversed, or rotated with one side given a second BC
    of the other kind."""
    rng = np.random.default_rng(7)
    out = []
    for n, kinds in enumerate(itertools.product(
            (None, "dirichlet", "neumann"), repeat=4)):
        items = [(k, s) for k, s in zip(kinds, SIDES) if k is not None]
        if order == "reversed":
            items = items[::-1]
        elif order == "repeated" and items:
            items = items[n % len(items):] + items[:n % len(items)]
            k, s = items[n % len(items)]
            other = "neumann" if k == "dirichlet" else "dirichlet"
            items.insert(0 if n % 2 else len(items), (other, s))
        out.append([BC(k, float(rng.normal()), s, 0.1, 0.15)
                    for k, s in items])
    return out


@pytest.mark.parametrize("order", ["canonical", "reversed", "repeated"])
def test_plan_bcs_apply_as_the_list(order):
    """The BC list the CPU twins apply, rebuilt from the edge plan, writes
    what the list itself writes, bitwise, on float64 and float32 fields
    (3x7 and 6x5: every edge cell next to a corner)."""
    rng = np.random.default_rng(11)
    for bcs in bc_lists(order):
        plan = pk.edge_plan(tuple(bcs))
        rebuilt = pk.plan_bcs(plan)
        assert pk.edge_plan(rebuilt) == plan
        for shape, dtype in (((3, 7), torch.float64), ((6, 5),
                                                       torch.float32)):
            a = field(rng, *shape).to(dtype)
            assert torch.equal(apply_bcs(a, rebuilt), apply_bcs(a, bcs))


def test_plan_bcs_refuses_a_plan_no_list_has():
    # each corner written by the side the next corner's writer is not
    plan = (0.0,) * 4 + (0.0, 3.0, 2.0, 1.0) + (1.0,) * 4
    with pytest.raises(ValueError, match="no BC list"):
        pk.plan_bcs(plan)


# --- the gated loops as while_loops ------------------------------------------


def wavefront_loop(p, rhs_c, dx, dy, beta, tol, max_iter):
    """`sor_wavefront` as it was: a Python loop with the gate read on the
    host."""
    nx, ny = p.shape
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 * (dx2 + dy2)
    ii = torch.arange(1, nx - 1)[:, None]
    jj = torch.arange(1, ny - 1)[None, :]
    flat, diag = (ii * ny + jj).flatten(), (ii + jj).flatten()
    stages = [flat[diag == d] for d in range(2, nx + ny - 3)]
    c = rhs_c.flatten()
    tol = poisson.dtype_float(tol, p.dtype)
    err, it = 1.0, 1
    while err > tol and it < max_iter:
        q = p.flatten().clone()
        for idx in stages:
            up, down = q[idx + ny], q[idx - ny]
            right, left = q[idx + 1], q[idx - 1]
            q[idx] = beta * (dy2 * (up + down) + dx2 * (right + left)
                             - c[idx]) / denom + (1.0 - beta) * q[idx]
        p_new = q.view(nx, ny)
        err = float((p_new - p).abs().max())
        p, it = p_new, it + 1
    return p, it


def cg_loop(p0, rhs, dx, dy, tol, max_iter):
    """`cg_poisson` as it was."""
    dx2, dy2 = dx * dx, dy * dy
    boundary = torch.ones_like(p0, dtype=torch.bool)
    boundary[1:-1, 1:-1] = False
    zero = torch.zeros((), dtype=p0.dtype)
    lap = lambda x: poisson.laplace_full(x, dx2, dy2)  # noqa: E731
    r = torch.where(boundary, zero, rhs - lap(p0))
    d, rs, e = r, torch.sum(r * r), torch.zeros_like(p0)
    tol = poisson.dtype_float(tol, p0.dtype)
    it = 0
    while float(torch.sqrt(torch.abs(rs))) > tol and it < max_iter:
        Ad = torch.where(boundary, zero, lap(d))
        alpha = rs / torch.sum(d * Ad)
        e, r = e + alpha * d, r - alpha * Ad
        rs_new = torch.sum(r * r)
        d = r + (rs_new / rs) * d
        rs, it = rs_new, it + 1
    return p0 + e, it


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_while_loops_are_the_python_loops(dtype):
    """Bitwise the old loops at a cap that binds and at a tolerance that
    stops first (sweep counts from 1 to the cap), one field and a batch."""
    rng = np.random.default_rng(5)
    for shape, tol, cap in (((9, 9), 1e-30, 7), ((17, 13), 1e-3, 400),
                            ((12, 16), 0.5, 50)):
        p, c = field(rng, *shape).to(dtype), field(rng, *shape).to(dtype)
        want, sweeps = wavefront_loop(p, c, 0.1, 0.12, 1.25, tol, cap)
        assert 1 <= sweeps <= cap
        assert torch.equal(poisson.sor_wavefront(p, c, 0.1, 0.12, 1.25, tol,
                                                 cap), want)
        want, iters = cg_loop(p, c, 0.1, 0.12, tol, cap)
        assert torch.equal(poisson.cg_poisson(p, c, 0.1, 0.12, tol, cap),
                           want)
        batch = poisson.cg_poisson(torch.stack([p, -p]), torch.stack([c, c]),
                                   0.1, 0.12, tol, cap)
        assert torch.equal(batch[0], want)
        assert torch.equal(batch[1], cg_loop(-p, c, 0.1, 0.12, tol, cap)[0])


def test_gated_loops_export_as_loops():
    """torch.export records cg and the wavefront SOR as while_loops whose
    carried state is what the Python loop kept, and the program gives the
    eager result bitwise."""
    rng = np.random.default_rng(9)
    p, c = field(rng, 11, 11), field(rng, 11, 11)

    class Solve(torch.nn.Module):
        def forward(self, p, c):
            return (poisson.sor_wavefront(p, c, 0.1, 0.1, 1.25, 1e-6, 40),
                    poisson.cg_poisson(p, c, 0.1, 0.1, 1e-8, 40))

    ep = torch.export.export(Solve(), (p, c))
    loops = [n for n in ep.graph.nodes
             if n.op == "call_function" and "while_loop" in str(n.target)]
    assert len(loops) == 2
    for got, want in zip(ep.module()(p, c), Solve()(p, c)):
        assert torch.equal(got, want)
    assert not math.isnan(float(want.sum()))
