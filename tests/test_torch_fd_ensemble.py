"""The port's batched FD steps (the JAX package's FD ensemble under vmap)
on the CPU: `ensemble_fd_rollout` on batch-polymorphic chorin_fd and
direct_fd steps against the JAX ensemble, each member against its own
single rollout, and the batched twins of K1, K2 and K3 member by member.

Bounds: the JAX ensemble within 1e-12 in float64 (tests/test_parallel.py:
145); in float32 within 1e-4 of the field's max, since the two packages
round a float32 expression at other places and an SOR gate fed other
roundings may stop a sweep apart (chip_smoke's 1e-3 for converged float32
gates, with headroom read off this file's grids). Every member of a batch
is bitwise its own single rollout or single call: the batch changes no
operation a member sees.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns_tpu_torch.cli.run_solver import cavity_bcs
from ns_tpu_torch.core.bc import apply_bcs, dirichlet, neumann
from ns_tpu_torch.core.state import FlowState
from ns_tpu_torch.ops import kernels, poisson
from ns_tpu_torch.parallel.ensemble import ensemble_fd_rollout
from ns_tpu_torch.solvers import chorin_fd, direct_fd

B = 4
NT = 3
FIELDS = ("u", "v", "p", "u_prev", "v_prev")

# (family, method, pressure mode, grid): the batched steps the JAX
# ensemble is held against. 17 = 2^4 + 1 keeps multigrid on its exact
# V-cycles; 20 its MGCG path; 'gauss_seidel' and 'cg' solve their members
# in turn (host gates)
CASES = [
    ("chorin_fd", "explicit", "redblack", 17),
    ("chorin_fd", "explicit", "dst", 17),
    ("chorin_fd", "semi_implicit", "redblack", 17),
    ("chorin_fd", "semi_implicit", "dst", 17),
    ("chorin_fd", "helmholtz", "redblack", 17),
    ("chorin_fd", "helmholtz", "dst", 17),
    ("chorin_fd", "semi_implicit", "multigrid", 17),
    ("chorin_fd", "explicit", "multigrid", 20),
    ("chorin_fd", "explicit", "gauss_seidel", 12),
    ("chorin_fd", "explicit", "cg", 12),
    ("direct_fd", None, "jacobi", 17),
    ("direct_fd", None, "exact", 17),
]
IDS = ["-".join(str(x) for x in c if x is not None) for c in CASES]


def _cfg_kw(family, method, mode, n):
    kw = dict(nt=NT, nx=n, ny=n, dt=1e-3, rho=1.0, nu=0.1,
              pressure_mode=mode)
    if family == "chorin_fd":
        kw.update(nit=50, beta=1.25, method=method)
    else:
        kw.update(nit=30)
    return kw


def _members_np(n, seed=0):
    """B initial (u, v, p) of one seed; member 1 starts at rest."""
    rng = np.random.default_rng(seed)
    out = []
    for m in range(B):
        scale = 0.0 if m == 1 else 0.01 * (m + 1)
        out.append(tuple(scale * rng.normal(size=(n, n)) for _ in range(3)))
    return out


def _port(case, dtype):
    """(step, [single states], batched state) of the port."""
    family, method, mode, n = case
    kw = _cfg_kw(family, method, mode, n)
    if family == "chorin_fd":
        cfg = chorin_fd.ChorinFDConfig(**kw)
        bcs = cavity_bcs(cfg.dx, cfg.dy)
        step = chorin_fd.make_step(cfg, *bcs, dtype=dtype, device="cpu")
        singles = [chorin_fd.init_state(cfg, u, v, p, *bcs, dtype=dtype,
                                        device="cpu")
                   for u, v, p in _members_np(n)]
    else:
        cfg = direct_fd.DirectFDConfig(**kw)
        bcs = cavity_bcs(cfg.dx, cfg.dy)
        step = direct_fd.make_step(cfg, *bcs)
        singles = [FlowState(*(torch.as_tensor(a, dtype=dtype) for a in m))
                   for m in _members_np(n)]
    return step, singles, stack(singles)


def stack(states):
    return FlowState(**{f: (None if getattr(states[0], f) is None else
                            torch.stack([getattr(s, f) for s in states]))
                        for f in FIELDS})


def single_rollout(step, state, nt=NT):
    for _ in range(nt):
        state = step(state)
    return state


def assert_members_bitwise(got, singles):
    for f in FIELDS:
        if getattr(got, f) is None:
            continue
        for m, s in enumerate(singles):
            assert torch.equal(getattr(got, f)[m], getattr(s, f)), (f, m)


def _jax_ensemble(case, dtype):
    """The JAX ensemble (jax.vmap of the step in a scan) of the same
    members, on a fake-device mesh."""
    from ns_tpu.cli.run_solver import cavity_bcs as jcavity
    from ns_tpu.core.state import FlowState as JState
    from ns_tpu.parallel import make_mesh
    from ns_tpu.parallel.ensemble import ensemble_fd_rollout as jens
    from ns_tpu.solvers import chorin_fd as jchorin, direct_fd as jdirect
    family, method, mode, n = case
    kw = _cfg_kw(family, method, mode, n)
    if family == "chorin_fd":
        cfg = jchorin.ChorinFDConfig(**kw)
        bcs = jcavity(cfg.dx, cfg.dy)
        step = jchorin.make_step(cfg, *bcs, dtype=dtype)
        members = [jchorin.init_state(cfg, u, v, p, *bcs, dtype=dtype)
                   for u, v, p in _members_np(n)]
    else:
        cfg = jdirect.DirectFDConfig(**kw)
        bcs = jcavity(cfg.dx, cfg.dy)
        step = jdirect.make_step(cfg, *bcs)
        members = [JState(*(jnp.asarray(a, dtype) for a in m))
                   for m in _members_np(n)]
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)
    mesh = make_mesh({"ensemble": B}, devices=jax.devices()[:B])
    return jens(step, batch, NT, mesh)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_batched_step_matches_jax_ensemble_f64(case):
    """ensemble_fd_rollout on the batched step against the JAX ensemble
    (vmapped), float64, within 1e-12; the step was called on the batch."""
    step, _, batch = _port(case, torch.float64)
    calls = []

    def counted(state):
        calls.append(state.u.dim())
        return step(state)

    counted.batch_polymorphic = step.batch_polymorphic
    got = ensemble_fd_rollout(counted, batch, NT)
    assert calls == [3] * NT
    want = _jax_ensemble(case, jnp.float64)
    for f in ("u", "v", "p"):
        err = np.abs(getattr(got, f).numpy()
                     - np.asarray(getattr(want, f))).max()
        assert err <= 1e-12, (f, err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_batched_members_are_their_single_rollouts(case, dtype):
    """Each member of the batched rollout is bitwise its own single-member
    rollout of the same step."""
    step, singles, batch = _port(case, dtype)
    got = ensemble_fd_rollout(step, batch, NT)
    assert_members_bitwise(got, [single_rollout(step, s) for s in singles])


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[10]],
                         ids=[IDS[0], IDS[3], IDS[10]])
def test_batched_step_matches_jax_ensemble_f32(case):
    """The same in float32, within 1e-4 of each field's max."""
    step, _, batch = _port(case, torch.float32)
    got = ensemble_fd_rollout(step, batch, NT)
    want = _jax_ensemble(case, jnp.float32)
    for f in ("u", "v", "p"):
        w = np.asarray(getattr(want, f), np.float64)
        err = np.abs(getattr(got, f).numpy() - w).max()
        assert err <= 1e-4 * max(1.0, np.abs(w).max()), (f, err)


@pytest.mark.parametrize("case", [CASES[0], CASES[10]],
                         ids=[IDS[0], IDS[10]])
def test_batch_of_one_is_the_unbatched_call(case):
    """A (1, nx, ny) batch gives the unbatched step's bits."""
    step, singles, _ = _port(case, torch.float64)
    one = stack(singles[:1])
    got = single_rollout(step, one)
    want = single_rollout(step, singles[0])
    for f in FIELDS:
        if getattr(want, f) is not None:
            assert getattr(got, f).shape[0] == 1
            assert torch.equal(getattr(got, f)[0], getattr(want, f))


def test_step_without_batch_support_runs_member_by_member():
    """A step that does not declare `batch_polymorphic` is called on one
    member at a time, and gives the batched step's bits."""
    step, singles, batch = _port(CASES[0], torch.float64)
    shapes = []

    def plain(state):
        shapes.append(tuple(state.u.shape))
        return step(state)

    got = ensemble_fd_rollout(plain, batch, NT)
    assert shapes == [tuple(singles[0].u.shape)] * (B * NT)
    assert_members_bitwise(got, [single_rollout(step, s) for s in singles])
    assert_members_bitwise(ensemble_fd_rollout(step, batch, NT),
                           [single_rollout(step, s) for s in singles])


def test_ensemble_share_of_a_world_of_one_is_the_batch():
    """With a mesh of one rank the share is the whole batch, stepped at
    once."""
    from ns_tpu_torch.parallel import make_mesh
    step, singles, batch = _port(CASES[3], torch.float64)
    mesh = make_mesh({"ensemble": 1}, device_type="cpu")
    got = ensemble_fd_rollout(step, batch, NT, mesh)
    assert_members_bitwise(got, [single_rollout(step, s) for s in singles])


# ---------------------------------------------------------------------------
# the batched twins of K1, K2, K3
# ---------------------------------------------------------------------------

def _sor_problem(n, dtype, seed=3):
    """A (B, n, n) SOR batch whose members stop at very different sweeps:
    one at rest (its gate closes after one sweep), one that starts at its
    own converged solution (a few sweeps), two random ones (many)."""
    h = 2.0 / (n - 1)
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(rng.normal(size=(B, n, n)), dtype=dtype)
    c = torch.as_tensor(h * h * rng.normal(size=(B, n, n)), dtype=dtype)
    p[1], c[1] = 0.0, 0.0
    p[2] = poisson.sor_redblack(p[2], c[2], h, h, 1.25, 5e-6, 200)
    return p, c, h


def _sweeps(p, c, h, tol, max_iter):
    masks = poisson.checkerboard(*p.shape, device=p.device)
    tol = poisson.dtype_float(tol, p.dtype)
    err, it = 1.0, 1
    while err > tol and it < max_iter:
        q = poisson.redblack_sweep(p, c, h, h, 1.25, masks)
        err = float((q - p).abs().max())
        p, it = q, it + 1
    return it - 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [17, 24])
def test_batched_k1_twin_gates_each_member(n, dtype):
    """The batched twin of K1 (`ops.poisson.sor_redblack`, the CPU route
    of `sor_redblack_fused`) is bitwise each member's single solve, with
    members stopping at different sweeps; a gate over the whole batch
    would run the early members on and change their bits."""
    p, c, h = _sor_problem(n, dtype)
    got = kernels.sor_redblack_fused(p, c, h, h, 1.25, 5e-6, 200)
    sweeps = []
    for m in range(B):
        want = poisson.sor_redblack(p[m], c[m], h, h, 1.25, 5e-6, 200)
        assert torch.equal(got[m], want), m
        sweeps.append(_sweeps(p[m], c[m], h, 5e-6, 200))
    assert sweeps[1] == 1 and sweeps[2] < min(sweeps[0], sweeps[3])
    longest = max(sweeps) + 1
    ran_on = poisson.sor_redblack(p[2], c[2], h, h, 1.25, 0.0, longest)
    assert not torch.equal(ran_on, got[2])


def test_batched_k1_twin_matches_jax_vmapped_kernel():
    """The batched twin of K1 against jax.vmap of the Pallas kernel in
    interpret mode (one pallas_call with a member axis), float64."""
    from ns_tpu.ops.pallas import sor_redblack_fused_pallas
    p, c, h = _sor_problem(17, torch.float64)
    got = kernels.sor_redblack_fused(p, c, h, h, 1.25, 5e-6, 200)
    want = jax.vmap(lambda a, b: sor_redblack_fused_pallas(
        a, b, h, h, 1.25, 5e-6, 200, interpret=True))(
            jnp.asarray(p.numpy()), jnp.asarray(c.numpy()))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12


def _k2_bcs(h):
    return [dirichlet(0, "top"), neumann(0, "bottom", h, h),
            neumann(0.5, "left", h, h), neumann(-0.25, "right", h, h)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_k2_twin_is_each_member(dtype):
    """The batched twin of K2 (Jacobi sweeps with the BC list after each)
    is bitwise each member's single call; and against jax.vmap of the
    Pallas kernel in interpret mode (float64, 1e-12)."""
    n, h = 17, 2.0 / 16
    rng = np.random.default_rng(5)
    p = torch.as_tensor(rng.normal(size=(B, n, n)), dtype=dtype)
    b = torch.as_tensor(10 * rng.normal(size=(B, n, n)), dtype=dtype)
    bcs = _k2_bcs(h)
    got = kernels.jacobi_fused(p, b, h, h, 25, bcs)
    for m in range(B):
        assert torch.equal(got[m], kernels.jacobi_fused(p[m], b[m], h, h, 25,
                                                        bcs))
    assert torch.equal(kernels.jacobi_multiblock(p, b, h, h, 25, bcs), got)
    if dtype == torch.float64:
        _k2_vs_jax(p, b, h, got)


def _k2_vs_jax(p, b, h, got):
    from ns_tpu.core.bc import dirichlet as jd, neumann as jn
    from ns_tpu.ops.pallas import jacobi_fused_pallas
    jbcs = [jd(0, "top"), jn(0, "bottom", h, h), jn(0.5, "left", h, h),
            jn(-0.25, "right", h, h)]
    want = jax.vmap(lambda a, c: jacobi_fused_pallas(
        a, c, h, h, 25, jbcs, interpret=True))(
            jnp.asarray(p.numpy()), jnp.asarray(b.numpy()))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-12


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_k3_twin_is_each_member(dtype, quirk):
    """The batched twin of K3 (`momentum_explicit`, the CPU route of
    `momentum_explicit_fused`) is bitwise each member's single call, with
    Neumann and Dirichlet velocity BCs; and against jax.vmap of the Pallas
    kernel in interpret mode (float64, 1e-12)."""
    n, h = 24, 2.0 / 23
    rng = np.random.default_rng(7)
    f = [torch.as_tensor(rng.normal(size=(B, n, n)), dtype=dtype)
         for _ in range(4)]
    u_bc = [neumann(0.5, "left", h, h), dirichlet(1, "right"),
            neumann(-0.25, "top", h, h), dirichlet(0, "bottom")]
    v_bc = [neumann(0, "bottom", h, h), dirichlet(0, "top"),
            dirichlet(0, "left"), neumann(-1.0, "right", h, h)]
    args = (1e-3, h, h, 0.1, u_bc, v_bc, quirk)
    got = kernels.momentum_explicit_fused(*f, *args)
    for m in range(B):
        want = kernels.momentum_explicit_fused(*(a[m] for a in f), *args)
        assert torch.equal(got[0][m], want[0])
        assert torch.equal(got[1][m], want[1])
    if dtype != torch.float64:
        return
    from ns_tpu.core.bc import dirichlet as jd, neumann as jn
    from ns_tpu.ops.pallas.momentum_kernels import (
        momentum_explicit_fused_pallas)
    ju = [jn(0.5, "left", h, h), jd(1, "right"), jn(-0.25, "top", h, h),
          jd(0, "bottom")]
    jv = [jn(0, "bottom", h, h), jd(0, "top"), jd(0, "left"),
          jn(-1.0, "right", h, h)]
    want = jax.vmap(lambda a, b, c, d: momentum_explicit_fused_pallas(
        a, b, c, d, 1e-3, h, h, 0.1, ju, jv, quirk_compat=quirk,
        tile_rows=8, interpret=True))(*(jnp.asarray(a.numpy()) for a in f))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-12


@pytest.mark.parametrize("shape", [(16, 16), (17, 16)])
def test_batched_tiled_sor_twins_solve_members_in_turn(shape):
    """K4's and K5's twins (host gates every 8 sweeps) take a batch as
    its members in turn: each member bitwise its single solve."""
    rng = np.random.default_rng(11)
    h = 2.0 / (shape[0] - 1)
    p = torch.as_tensor(rng.normal(size=(3, *shape)))
    c = torch.as_tensor(h * h * rng.normal(size=(3, *shape)))
    twins = [kernels.sor_redblack_tiled]
    if shape[1] % 2 == 0:
        twins.append(kernels.sor_redblack_packed_tiled)
    for twin in twins:
        got = twin(p, c, h, h, 1.25, 5e-6, 60)
        for m in range(3):
            assert torch.equal(got[m], twin(p[m], c[m], h, h, 1.25, 5e-6,
                                            60))
    got = kernels.sor_redblack_multiblock(p, c, h, h, 1.25, 5e-6, 60)
    assert torch.equal(got, kernels.sor_redblack_tiled(p, c, h, h, 1.25,
                                                       5e-6, 60))


def test_batched_bcs_and_dst_solves_are_each_member():
    """apply_bcs, the dst and mixed-BC solves and the multigrid take a
    leading member axis: each member bitwise its single call."""
    from ns_tpu_torch.ops.fast_poisson import (make_dst_helmholtz,
                                               make_dst_poisson,
                                               make_mixed_poisson)
    from ns_tpu_torch.ops.multigrid import poisson_multigrid
    n, h = 17, 2.0 / 16
    rng = np.random.default_rng(13)
    p = torch.as_tensor(rng.normal(size=(B, n, n)))
    f = torch.as_tensor(rng.normal(size=(B, n, n)))
    bcs = cavity_bcs(h, h)[2]
    dst = make_dst_poisson(n, n, h, h, dtype=torch.float64)
    hel = make_dst_helmholtz(n, n, h, h, 0.05, dtype=torch.float64)
    mixed = make_mixed_poisson(n, n, h, h, bcs)
    calls = {"apply_bcs": (lambda q, g: apply_bcs(q, bcs)),
             "dst": dst,
             "helmholtz": lambda q, g: hel(q, g[..., 1:-1, 1:-1]),
             "mixed": lambda q, g: mixed(g),
             "multigrid": lambda q, g: poisson_multigrid(q, g, h, h, 3),
             "mgcg": lambda q, g: poisson_multigrid(q[..., :15, :15],
                                                    g[..., :15, :15], h, h,
                                                    3)}
    for name, fn in calls.items():
        got = fn(p, f)
        for m in range(B):
            assert torch.equal(got[m], fn(p[m], f[m])), (name, m)
