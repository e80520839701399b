"""The port's sharded solvers, halo exchange, meshes and ensembles
(ns_tpu_torch.parallel) on gloo gangs of 2 and 4 CPU ranks, against the
single-device port and the JAX package's sharded functions.

One gang a rank count (a module fixture): each rank of the gang runs every
scenario below on its block, writes its shards with `save_array_shards`
and its collective counts as JSON, and the tests compare what the parent
reassembles. Every rank asserts that neither jax nor ns_tpu was imported
(this file imports them inside test bodies only). Bounds are the JAX
tests' own (tests/test_parallel.py, test_spectral_sharded.py,
test_utils_aux.py:49), float64: direct_fd 1e-13, exact 1e-10 (p 1e-9),
spectral 1e-11 (1e-10 where the JAX test uses it); the FD ensemble members
equal their single rollouts run in the same rank bitwise, and the parent's
and JAX's within 1e-12.

Collective counts are held to the JAX budgets (tests/test_collectives.py).
JAX counts collective sites in the lowered program (a loop body once); the
port counts calls, so a budget is read as sites = count(nt) - (nt - 1) *
per_step, with per_step = count(nt) - count(nt - 1).
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from ns_tpu_torch.cli.run_solver import cavity_bcs
from ns_tpu_torch.core.state import FlowState
from ns_tpu_torch.parallel import distributed as dist
from ns_tpu_torch.parallel import MESH_PRESETS, make_mesh
from ns_tpu_torch.parallel.mesh import (Sharding, axis_sizes,
                                        member_range, shard)
from ns_tpu_torch.solvers import chorin_fd, direct_fd
from ns_tpu_torch.solvers import spectral_periodic as sp

GANG_TIMEOUT = 120


# ---------------------------------------------------------------------------
# configurations (shared by the ranks and the parent)
# ---------------------------------------------------------------------------

def dfd_cfg(nt=5, nit=20, mode="jacobi"):
    return direct_fd.DirectFDConfig(nt=nt, nit=nit, nx=48, ny=48, dt=0.001,
                                    rho=1.0, nu=0.1, pressure_mode=mode)


def fft_cfg(nt=10):
    return sp.SpectralPeriodicConfig(nt=nt, nx=32, ny=32, dt=0.005, nu=1e-3,
                                     dtype="float64")


def compact_cfg(nt=8):
    return sp.SpectralPeriodicConfig(nt=nt, nx=32, ny=32, dt=0.005, nu=1e-3,
                                     dtype="float64", transform="matmul",
                                     matmul_precision="highest",
                                     compact_spectrum=True, dealias=True)


def chorin_cfg():
    return chorin_fd.ChorinFDConfig(nt=4, nx=24, ny=24, dt=1e-3, rho=1.0,
                                    nu=0.1, beta=1.25,
                                    method="semi_implicit",
                                    pressure_mode="dst")


def chorin_members(cfg, n=4):
    """n chorin_fd initial states from one seed (as numpy fields)."""
    rng = np.random.default_rng(0)
    return [0.01 * rng.normal(size=(cfg.nx, cfg.ny)) for _ in range(n)]


def ensemble_w0(cfg, B=8):
    return np.stack([sp.decaying_turbulence_vorticity(cfg, seed=i)
                     for i in range(B)])


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _zeros_state(n=48):
    z = torch.zeros((n, n), dtype=torch.float64)
    return FlowState(u=z, v=z, p=z)


def _dfd(out, mesh, cfg, **kw):
    from ns_tpu_torch.parallel import direct_fd_sharded as dfs
    u_bc, v_bc, p_bc = cavity_bcs(cfg.dx, cfg.dy)
    seqs = dfs.simulate(cfg, _zeros_state(), u_bc, v_bc, p_bc, mesh, **kw)
    for name, arr in zip("uvp", seqs):
        dist.save_array_shards(out, name, arr)


def _dfd_step_counts(out, mesh, cfg):
    """Counts of one step of the sharded direct_fd step."""
    from ns_tpu_torch.parallel import direct_fd_sharded as dfs
    from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
    u_bc, v_bc, p_bc = cavity_bcs(cfg.dx, cfg.dy)
    step, sharding = dfs.make_sharded_step(cfg, u_bc, v_bc, p_bc, mesh)
    z = shard(sharding, torch.zeros((48, 48), dtype=torch.float64))
    reset_counts()
    step(FlowState(u=z, v=z, p=z))
    return dict(COUNTS)


def _spectral(out, mesh, kind, cfg, w0, **kw):
    from ns_tpu_torch.parallel import spectral_sharded as ss
    from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
    make = {"fft": ss.make_sharded_rollout,
            "fft_sim": ss.make_sharded_simulate,
            "compact": ss.make_sharded_compact_rollout,
            "sim_w": lambda c, m: ss.make_sharded_compact_simulate(
                c, m, fields="w"),
            "sim_uvp": lambda c, m: ss.make_sharded_compact_simulate(
                c, m, fields="uvp")}[kind]
    fn, sharding = make(cfg, mesh, **kw)
    reset_counts()
    got = fn(shard(sharding, w0))
    counts = dict(COUNTS)
    for i, arr in enumerate(got if isinstance(got, tuple) else (got,)):
        dist.save_array_shards(out, f"f{i}", arr)
    return counts


def _halo(out, mesh):
    from ns_tpu_torch.parallel.halo import (exchange_halo_cols,
                                            exchange_halo_rows)
    a = torch.arange(16.0, dtype=torch.float64).reshape(8, 2)
    sh = Sharding(mesh, ("x", None))
    rows = exchange_halo_rows(shard(sh, a).local, mesh, "x")
    dist.save_array_shards(out, "rows", dist.global_array(sh, rows))
    b = torch.arange(16.0, dtype=torch.float64).reshape(2, 8)
    shc = Sharding(mesh, (None, "x"))
    cols = exchange_halo_cols(shard(shc, b).local, mesh, "x")
    dist.save_array_shards(out, "cols", dist.global_array(shc, cols))


def _fd_ensemble(out, mesh):
    from ns_tpu_torch.parallel.ensemble import ensemble_fd_rollout
    cfg = chorin_cfg()
    u_bc, v_bc, p_bc = cavity_bcs(cfg.dx, cfg.dy)
    step = chorin_fd.make_step(cfg, u_bc, v_bc, p_bc, dtype=torch.float64,
                               device="cpu")
    z = np.zeros((cfg.nx, cfg.ny))
    members = [chorin_fd.init_state(cfg, u0, z, z, u_bc, v_bc, p_bc,
                                    dtype=torch.float64, device="cpu")
               for u0 in chorin_members(cfg)]
    batch = FlowState(*(torch.stack([getattr(m, f) for m in members])
                        for f in ("u", "v", "p", "u_prev", "v_prev")))
    got = ensemble_fd_rollout(step, batch, cfg.nt, mesh)
    # the share's members rolled out one at a time in this process: the
    # ensemble must equal them bitwise
    lo, hi = member_range(len(members), mesh, "ensemble")
    singles = []
    for s in members[lo:hi]:
        for _ in range(cfg.nt):
            s = step(s)
        singles.append(s)
    sh = Sharding(mesh, ("ensemble", None, None))
    for f in ("u", "v", "p"):
        dist.save_array_shards(out, f, dist.global_array(sh, getattr(got,
                                                                     f)))
        dist.save_array_shards(out, "single_" + f, dist.global_array(
            sh, torch.stack([getattr(s, f) for s in singles])))


def _spectral_ensemble(out, mesh):
    from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
    from ns_tpu_torch.parallel.ensemble import (ensemble_energy,
                                                ensemble_init,
                                                ensemble_rollout_final)
    cfg = fft_cfg()
    reset_counts()
    carry = ensemble_init(cfg, ensemble_w0(cfg), mesh)
    w_hat, _ = ensemble_rollout_final(cfg, carry)
    rolled = dict(COUNTS)
    e = ensemble_energy(cfg, w_hat, mesh)
    sh = Sharding(mesh, ("ensemble", None, None))
    dist.save_array_shards(out, "w_hat", dist.global_array(sh, w_hat))
    return {"rollout": rolled, "energy": float(e), "all": dict(COUNTS)}


def _scenarios(world):
    """name -> fn(out_dir) run on every rank of a gang of `world`."""
    x = lambda: make_mesh({"x": world})  # noqa: E731
    tg = lambda cfg: sp.taylor_green_vorticity(cfg)  # noqa: E731
    dt = sp.decaying_turbulence_vorticity
    s = {
        "halo": lambda o: _halo(o, x()),
        "dfd": lambda o: _dfd(o, x(), dfd_cfg()),
        "exact": lambda o: _dfd(o, x(), dfd_cfg(nt=4, mode="exact")),
        "dfd_counts": lambda o: {
            f"nit{k}": _dfd_step_counts(o, x(), dfd_cfg(nit=k))
            for k in (1, 3)} | {"exact": _dfd_step_counts(
                o, x(), dfd_cfg(mode="exact"))},
        "fft": lambda o: _spectral(o, x(), "fft", fft_cfg(),
                                   dt(fft_cfg(), seed=0)),
        "compact": lambda o: _spectral(o, x(), "compact", compact_cfg(),
                                       dt(compact_cfg(), seed=1)),
        "fd_ensemble": lambda o: _fd_ensemble(
            o, make_mesh({"ensemble": world})),
        "spectral_ensemble": lambda o: _spectral_ensemble(
            o, make_mesh({"ensemble": world})),
    }
    if world == 2:
        s["sim_uvp"] = lambda o: _spectral(o, x(), "sim_uvp",
                                           compact_cfg(nt=4),
                                           dt(compact_cfg(), seed=3))
        s["presets"] = lambda o: {
            "ensemble_default": axis_sizes(make_mesh()),
            "rows": list(dist.process_local_rows(32, make_mesh(
                {"ensemble": 2, "x": 1}), "x"))}
    if world == 4:
        s.update({
            "dfd2d": lambda o: _dfd(o, make_mesh({"x": 2, "y": 2}),
                                    dfd_cfg(nt=4, nit=15), axis="x",
                                    axis_y="y"),
            "dfd1x4": lambda o: _dfd(o, make_mesh({"x": 1, "y": 4}),
                                     dfd_cfg(nt=4, nit=15), axis="x",
                                     axis_y="y"),
            "odd": lambda o: _spectral(o, x(), "fft", fft_cfg(nt=5),
                                       tg(fft_cfg())),
            "padded": lambda o: _spectral(o, x(), "compact",
                                          compact_cfg(nt=4),
                                          tg(compact_cfg())),
            "sim_w": lambda o: _spectral(o, x(), "sim_w", compact_cfg(nt=5),
                                         dt(compact_cfg(), seed=2)),
            "fft_sim": lambda o: _spectral(o, x(), "fft_sim", fft_cfg(nt=6),
                                           dt(fft_cfg(), seed=4)),
            "counts": lambda o: {
                f"{kind}{nt}": _spectral(
                    os.path.join(o, f"{kind}{nt}"), x(), kind,
                    (fft_cfg if kind == "fft_sim" else compact_cfg)(nt=nt),
                    tg(fft_cfg()))
                for kind in ("fft_sim", "compact", "sim_uvp")
                for nt in (2, 3)},
            "ens_x": lambda o: _spectral(
                o, make_mesh({"ensemble": 2, "x": 2}), "compact",
                compact_cfg(nt=6), ensemble_w0(compact_cfg(), 4),
                ens_axis="ensemble"),
        })
    return s


def _gang_worker(rank, world, init, out):
    """One rank: every scenario of `world`, shards and counts under out."""
    assert "jax" not in sys.modules
    torch.set_num_threads(1)
    dist.initialize(init, world, rank, "cpu")
    results = {}
    for name, fn in _scenarios(world).items():
        sub = os.path.join(out, name)
        results[name] = fn(sub)
        dist.barrier()
    with open(os.path.join(out, f"results.{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.shutdown()
    assert "jax" not in sys.modules
    assert not any(m.split(".")[0] == "ns_tpu" for m in sys.modules)


def start_gang(worker, world: int, out: str):
    """Spawn `world` ranks of worker(rank, world, init_url, out) (a
    top-level function of a test file). The process group meets at a
    file:// URL under `out`, so concurrent test workers never share a
    port."""
    return torch.multiprocessing.start_processes(
        worker, args=(world, "file://" + os.path.join(out, "init"), out),
        nprocs=world, join=False, start_method="spawn")


def join_gang(ctx, deadline: float) -> None:
    """Wait for a gang until the monotonic `deadline`; a rank's failure
    raises here, and ranks still running at the deadline are killed."""
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a gang did not finish in {GANG_TIMEOUT} s")


def run_gang(worker, world: int, out: str) -> None:
    join_gang(start_gang(worker, world, out),
              time.monotonic() + GANG_TIMEOUT)


class Gang:
    def __init__(self, world, out):
        self.world, self.out = world, out
        self.results = [json.load(open(os.path.join(out,
                                                    f"results.{r}.json")))
                        for r in range(world)]

    def field(self, scenario, name):
        return dist.assemble_shards(os.path.join(self.out, scenario), name)


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The gangs of 2 and 4 ranks, run at the same time."""
    outs = {n: str(tmp_path_factory.mktemp(f"gang{n}")) for n in (2, 4)}
    ctxs = {n: start_gang(_gang_worker, n, out) for n, out in outs.items()}
    deadline = time.monotonic() + GANG_TIMEOUT
    for ctx in ctxs.values():
        join_gang(ctx, deadline)
    return {n: Gang(n, out) for n, out in outs.items()}


@pytest.fixture(scope="module")
def gang2(gangs):
    return gangs[2]


@pytest.fixture(scope="module")
def gang4(gangs):
    return gangs[4]


def gang_of(request, n):
    return request.getfixturevalue(f"gang{n}")


# ---------------------------------------------------------------------------
# single-device and JAX references
# ---------------------------------------------------------------------------

def port_dfd(cfg):
    u_bc, v_bc, p_bc = cavity_bcs(cfg.dx, cfg.dy)
    z = np.zeros((cfg.nx, cfg.ny))
    sys_ = direct_fd.NavierStokesSystem(
        z, z, z, u_bc, v_bc, p_bc, nt=cfg.nt, nit=cfg.nit, nx=cfg.nx,
        ny=cfg.ny, dt=cfg.dt, rho=1, nu=cfg.nu, dtype=torch.float64,
        device="cpu", pressure_mode=cfg.pressure_mode)
    return [a.numpy() for a in sys_.simulate()]


def jax_dfd(cfg, shape, axis_y=None):
    import jax
    import jax.numpy as jnp
    from ns_tpu.core.bc import dirichlet, neumann
    from ns_tpu.core.state import FlowState as JState
    from ns_tpu.parallel import direct_fd_sharded as jdfs
    from ns_tpu.parallel import make_mesh as jmesh
    from ns_tpu.solvers import direct_fd as jdirect
    jcfg = jdirect.DirectFDConfig(nt=cfg.nt, nit=cfg.nit, nx=cfg.nx,
                                  ny=cfg.ny, dt=cfg.dt, rho=cfg.rho,
                                  nu=cfg.nu, pressure_mode=cfg.pressure_mode)
    dx, dy = cfg.dx, cfg.dy
    u_bc = [dirichlet(0, "left"), dirichlet(1, "right"),
            dirichlet(0, "top"), dirichlet(0, "bottom")]
    v_bc = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    p_bc = [dirichlet(0, "top"), neumann(0, "bottom", dx, dy),
            neumann(0, "left", dx, dy), neumann(0, "right", dx, dy)]
    n = int(np.prod(list(shape.values())))
    mesh = jmesh(shape, devices=jax.devices()[:n])
    z = jnp.zeros((cfg.nx, cfg.ny), jnp.float64)
    seqs = jdfs.simulate(jcfg, JState(u=z, v=z, p=z), u_bc, v_bc, p_bc,
                         mesh, axis="x", axis_y=axis_y)
    return [np.asarray(a) for a in seqs]


def jax_spectral(kind, cfg, w0, shape, **kw):
    import jax
    from ns_tpu.parallel import make_mesh as jmesh
    from ns_tpu.parallel import spectral_sharded as jss
    from ns_tpu.solvers import spectral_periodic as jsp
    jcfg = jsp.SpectralPeriodicConfig(
        nt=cfg.nt, nx=cfg.nx, ny=cfg.ny, dt=cfg.dt, nu=cfg.nu,
        dtype=cfg.dtype, transform=cfg.transform,
        matmul_precision=cfg.matmul_precision,
        compact_spectrum=cfg.compact_spectrum, dealias=cfg.dealias)
    n = int(np.prod(list(shape.values())))
    mesh = jmesh(shape, devices=jax.devices()[:n])
    make = {"fft": jss.make_sharded_rollout,
            "fft_sim": jss.make_sharded_simulate,
            "compact": jss.make_sharded_compact_rollout,
            "sim_w": lambda c, m: jss.make_sharded_compact_simulate(
                c, m, fields="w"),
            "sim_uvp": lambda c, m: jss.make_sharded_compact_simulate(
                c, m, fields="uvp")}[kind]
    fn, sharding = make(jcfg, mesh, **kw)
    got = fn(jax.device_put(np.asarray(w0), sharding))
    return [np.asarray(a) for a in (got if isinstance(got, tuple)
                                    else (got,))]


def port_final(cfg, w0):
    """The single-device port's final vorticity (rollout_final)."""
    carry = sp.init_from_vorticity(cfg, w0, device="cpu")
    w_hat, _ = sp.rollout_final(cfg, carry)
    return sp.physical_from_carry(cfg, w_hat).numpy()


def close(got, want, atol):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, err


# ---------------------------------------------------------------------------
# tests: halo, meshes
# ---------------------------------------------------------------------------

def test_halo_exchange_rows_and_cols(gang4):
    """tests/test_parallel.py::test_halo_exchange_rows: each padded block
    holds its neighbours' edge rows, zeros at the ends of the chain."""
    a = np.arange(16.0).reshape(8, 2)
    rows = gang4.field("halo", "rows")           # (8 + 2*4, 2)
    np.testing.assert_array_equal(rows[4:8], a[1:5])
    np.testing.assert_array_equal(rows[0], 0.0)
    np.testing.assert_array_equal(rows[-1], 0.0)
    for r in range(4):
        np.testing.assert_array_equal(rows[4 * r + 1:4 * r + 3],
                                      a[2 * r:2 * r + 2])
    cols = gang4.field("halo", "cols")           # (2, 8 + 2*4)
    b = np.arange(16.0).reshape(2, 8)
    np.testing.assert_array_equal(cols[:, 4:8], b[:, 1:5])
    np.testing.assert_array_equal(cols[:, 0], 0.0)


def test_mesh_preset_and_validation(gang2):
    """tests/test_parallel.py::test_mesh_preset_and_validation: presets by
    name, every rank on 'ensemble' by default, the JAX error text on a
    size mismatch; a world of 1 needs no process group."""
    res = gang2.results[1]["presets"]
    assert res["ensemble_default"] == {"ensemble": 2}
    assert res["rows"] == [0, 32]        # 'x' of size 1: every row
    assert MESH_PRESETS["host-8"] == {"ensemble": 4, "x": 2}
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        make_mesh("host-8", device_type="cpu")
    with pytest.raises(ValueError, match="need 3 devices, have 1"):
        make_mesh({"x": 3}, device_type="cpu")
    assert axis_sizes(make_mesh("single", device_type="cpu")) == {
        "ensemble": 1, "x": 1}


# ---------------------------------------------------------------------------
# tests: direct_fd_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_direct_fd_matches_single_device(request, n_shards):
    g = gang_of(request, n_shards)
    cfg = dfd_cfg()
    ref = port_dfd(cfg)
    want_jax = jax_dfd(cfg, {"x": n_shards})
    for name, r, j in zip("uvp", ref, want_jax):
        got = g.field("dfd", name)
        close(got, r, 1e-13)
        close(got, j, 1e-13)


@pytest.mark.parametrize("scenario,shape", [
    ("dfd2d", {"x": 2, "y": 2}), ("dfd1x4", {"x": 1, "y": 4})])
def test_2d_sharded_direct_fd_matches_single_device(gang4, scenario, shape):
    """The 2D rows x cols decomposition (the JAX test's {x: 2, y: 4}
    needs 8 ranks; {x: 1, y: 4} shards the columns four ways)."""
    cfg = dfd_cfg(nt=4, nit=15)
    ref = port_dfd(cfg)
    want_jax = jax_dfd(cfg, shape, axis_y="y")
    for name, r, j in zip("uvp", ref, want_jax):
        got = gang4.field(scenario, name)
        close(got, r, 1e-13)
        close(got, j, 1e-13)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_direct_fd_exact_pressure_matches_single_device(request,
                                                                n_shards):
    g = gang_of(request, n_shards)
    cfg = dfd_cfg(nt=4, mode="exact")
    ref = port_dfd(cfg)
    want_jax = jax_dfd(cfg, {"x": n_shards})
    for name, r, j in zip("uvp", ref, want_jax):
        # the JAX test's bounds: u, v 1e-10, p 1e-9; the last frame
        bound = 1e-9 if name == "p" else 1e-10
        got = g.field("exact", name)
        close(got, r, bound)
        close(got[-1], j[-1], bound)


def test_sharded_direct_fd_exact_rejects_2d_mesh():
    from ns_tpu_torch.parallel import direct_fd_sharded as dfs
    cfg = direct_fd.DirectFDConfig(nx=16, ny=16, pressure_mode="exact")
    u_bc, v_bc, p_bc = cavity_bcs(cfg.dx, cfg.dy)
    mesh = make_mesh({"x": 1, "y": 1}, device_type="cpu")
    with pytest.raises(ValueError, match="1D row decomposition"):
        dfs.make_sharded_step(cfg, u_bc, v_bc, p_bc, mesh, axis="x",
                              axis_y="y")


def test_direct_fd_halo_budget(gang4):
    """tests/test_collectives.py::test_direct_fd_halo_budget: 4 exchange
    sites a step (source term u and v, the Jacobi body, momentum) of 2
    ppermutes each; the nit sweeps reuse the body's site. 'exact' swaps
    the body for 2 all_to_all."""
    res = gang4.results[0]["dfd_counts"]
    one, three = res["nit1"], res["nit3"]
    per_sweep = (three["collective_permute"]
                 - one["collective_permute"]) // 2
    assert per_sweep == 2
    assert one["collective_permute"] == 8
    assert "all_to_all" not in one
    assert res["exact"]["collective_permute"] == 6
    assert res["exact"]["all_to_all"] == 2


# ---------------------------------------------------------------------------
# tests: spectral_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_spectral_matches_unsharded(request, n_shards):
    g = gang_of(request, n_shards)
    cfg = fft_cfg()
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=0)
    got = g.field("fft", "f0")
    close(got, port_final(cfg, w0), 1e-11)
    close(got, jax_spectral("fft", cfg, w0, {"x": n_shards})[0], 1e-11)


def test_sharded_spectral_odd_halfwidth(gang4):
    """ny//2+1 = 17 over 4 ranks: the padded transpose; the Taylor-Green
    decay still holds."""
    cfg = fft_cfg(nt=5)
    assert (cfg.ny // 2 + 1) % 4 != 0
    w0 = sp.taylor_green_vorticity(cfg)
    got = gang4.field("odd", "f0")
    t = cfg.nt * cfg.dt
    close(got, w0 * np.exp(-2 * cfg.nu * t), 1e-10)
    close(got, jax_spectral("fft", cfg, w0, {"x": 4})[0], 1e-11)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_compact_matches_unsharded(request, n_shards):
    g = gang_of(request, n_shards)
    cfg = compact_cfg()
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=1)
    got = g.field("compact", "f0")
    close(got, port_final(cfg, w0), 1e-11)
    close(got, jax_spectral("compact", cfg, w0, {"x": n_shards})[0], 1e-11)


def test_sharded_compact_padded_ky(gang4):
    """kyc = 11 at 32^2 over 4 ranks: zero-padded ky chunks end to end."""
    cfg = compact_cfg(nt=4)
    assert sp._compact_meta(cfg)[3] % 4 != 0
    w0 = sp.taylor_green_vorticity(cfg)
    got = gang4.field("padded", "f0")
    t = cfg.nt * cfg.dt
    close(got, w0 * np.exp(-2 * cfg.nu * t), 1e-10)
    close(got, jax_spectral("compact", cfg, w0, {"x": 4})[0], 1e-11)


def test_sharded_compact_simulate_stacked_w(gang4):
    cfg = compact_cfg(nt=5)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=2)
    sys_ = sp.NavierStokesSystem(
        w0, nt=cfg.nt, nx=cfg.nx, ny=cfg.ny, dt=cfg.dt, nu=cfg.nu,
        dtype="float64", transform="matmul", matmul_precision="highest",
        compact_spectrum=True, device="cpu")
    got = gang4.field("sim_w", "f0")
    assert got.shape == (cfg.nt, cfg.nx, cfg.ny)
    close(got, sys_.simulate_vorticity().numpy(), 1e-11)
    close(got, jax_spectral("sim_w", cfg, w0, {"x": 4})[0], 1e-11)


def test_sharded_compact_simulate_uvp(gang2):
    """fields='uvp': u, v equal the single-device fields, the flow is
    divergence-free, p equals the JAX sharded pressure (the compact
    truncated Poisson solve, not the single-device rfft2 one)."""
    cfg = compact_cfg(nt=4)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=3)
    sys_ = sp.NavierStokesSystem(
        w0, nt=cfg.nt, nx=cfg.nx, ny=cfg.ny, dt=cfg.dt, nu=cfg.nu,
        dtype="float64", transform="matmul", matmul_precision="highest",
        compact_spectrum=True, device="cpu")
    u_ref, v_ref, _ = (a.numpy() for a in sys_.simulate())
    u, v, p = (gang2.field("sim_uvp", f"f{i}") for i in range(3))
    assert u.shape == (cfg.nt, cfg.nx, cfg.ny)
    close(u, u_ref, 1e-11)
    close(v, v_ref, 1e-11)
    kx = np.fft.fftfreq(cfg.nx, d=1.0 / cfg.nx)[:, None]
    ky = np.fft.rfftfreq(cfg.ny, d=1.0 / cfg.ny)[None, :]
    div_hat = 1j * kx * np.fft.rfft2(u[-1]) + 1j * ky * np.fft.rfft2(v[-1])
    assert np.abs(np.fft.irfft2(div_hat, s=(cfg.nx, cfg.ny))).max() < 1e-10
    for got, want in zip((u, v, p),
                         jax_spectral("sim_uvp", cfg, w0, {"x": 2})):
        close(got, want, 1e-11)


def test_sharded_compact_rejects_fft_config():
    from ns_tpu_torch.parallel.spectral_sharded import (
        make_sharded_compact_rollout)
    cfg = sp.SpectralPeriodicConfig(nx=32, ny=32, transform="fft")
    with pytest.raises(ValueError, match="matmul"):
        make_sharded_compact_rollout(cfg, make_mesh({"x": 1},
                                                    device_type="cpu"))


@pytest.mark.parametrize("prec", ["default", "high"])
def test_sharded_compact_on_one_rank_is_the_engine(prec):
    """On a mesh of one rank (no process group) the sharded compact
    rollout and simulate run the single-device engine's own GEMM stages,
    nonlinear term and step: float32, bitwise."""
    from ns_tpu_torch.parallel import spectral_sharded as ss
    cfg = sp.SpectralPeriodicConfig(nt=6, nx=48, ny=48, dt=5e-4, nu=1e-4,
                                    transform="matmul",
                                    matmul_precision=prec,
                                    compact_spectrum=True)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=3)
    mesh = make_mesh({"x": 1}, device_type="cpu")
    roll, sharding = ss.make_sharded_compact_rollout(cfg, mesh)
    carry = sp.init_from_vorticity(cfg, w0, "cpu")
    want = sp.physical_from_carry(cfg, sp.rollout_final(cfg, carry)[0])
    assert torch.equal(roll(shard(sharding, w0)).local, want)
    sim, sharding = ss.make_sharded_compact_simulate(cfg, mesh, fields="w")
    want = sp.physical_from_carry(cfg, sp.simulate_hat(cfg, carry))
    assert torch.equal(sim(shard(sharding, w0)).local, want)


def test_sharded_compact_ensemble_by_spatial_mesh(gang4):
    """A 2D mesh (ensemble x spatial): every batch member equals its own
    single-device compact rollout."""
    cfg = compact_cfg(nt=6)
    w0s = ensemble_w0(cfg, 4)
    got = gang4.field("ens_x", "f0")
    assert got.shape == (4, cfg.nx, cfg.ny)
    for b in range(4):
        close(got[b], port_final(cfg, w0s[b]), 1e-11)


def test_sharded_fft_simulate_stacked(gang4):
    cfg = fft_cfg(nt=6)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=4)
    sys_ = sp.NavierStokesSystem(w0, nt=cfg.nt, nx=cfg.nx, ny=cfg.ny,
                                 dt=cfg.dt, nu=cfg.nu, dtype="float64",
                                 device="cpu")
    got = gang4.field("fft_sim", "f0")
    assert got.shape == (cfg.nt, cfg.nx, cfg.ny)
    close(got, sys_.simulate_vorticity().numpy(), 1e-11)
    close(got, jax_spectral("fft_sim", cfg, w0, {"x": 4})[0], 1e-11)


def _sites(counts, kind, key):
    """(sites, per step): JAX's site count read from the port's call
    counts at nt = 2 and 3 (the count at nt = 2 less one step's)."""
    two, three = counts[f"{kind}2"][key], counts[f"{kind}3"][key]
    per_step = three - two
    return two - per_step, per_step


def test_spectral_one_all_to_all_per_transform(gang4):
    """tests/test_collectives.py:49, :63: the distributed FFT simulate is
    6 init sites + 6 a step = 12; the compact rollout 3 init + 2 a step +
    1 output = 6; simulate-uvp 3 init + 5 a step = 8. Nothing but
    all_to_all, all of it on 'x'."""
    counts = gang4.results[2]["counts"]
    for kind, sites, per_step in (("fft_sim", 12, 6), ("compact", 6, 2),
                                  ("sim_uvp", 8, 5)):
        got_sites, step = _sites(counts, kind, "all_to_all")
        assert step == per_step, (kind, step)
        assert got_sites == sites, (kind, got_sites)
        for nt in (2, 3):
            assert set(counts[f"{kind}{nt}"]) == {"all_to_all",
                                                  "all_to_all@x"}


def test_ensemble_axis_never_communicates(gang4):
    """tests/test_collectives.py:191: an ensemble x spatial rollout makes
    its all_to_alls on 'x' only (6 sites: nt = 6 gives 3 + 12 + 1 calls),
    none on 'ensemble'; an ensemble rollout alone makes none at all."""
    ens_x = gang4.results[3]["ens_x"]
    assert ens_x == {"all_to_all": 16, "all_to_all@x": 16}
    assert gang4.results[1]["spectral_ensemble"]["rollout"] == {}


# ---------------------------------------------------------------------------
# tests: ensembles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_ranks", [2, 4])
def test_ensemble_sharded_rollout_matches_unsharded(request, n_ranks):
    """tests/test_utils_aux.py:49: B = 8 over the ensemble ranks; member 3
    against its own rollout, the JAX ensemble, and the energy."""
    import jax
    from ns_tpu.parallel import make_mesh as jmesh
    from ns_tpu.parallel.ensemble import (ensemble_energy as jenergy,
                                          ensemble_init as jinit,
                                          ensemble_rollout_final as jroll)
    from ns_tpu.solvers import spectral_periodic as jsp
    g = gang_of(request, n_ranks)
    cfg = fft_cfg()
    w0s = ensemble_w0(cfg)
    w_hat = g.field("spectral_ensemble", "w_hat")
    assert w_hat.shape[0] == 8
    c0 = sp.init_from_vorticity(cfg, w0s[3], device="cpu")
    w_ref, _ = sp.rollout_final(cfg, c0)
    close(w_hat[3], w_ref.numpy(), 1e-10)
    jcfg = jsp.SpectralPeriodicConfig(nt=10, nx=32, ny=32, dt=0.005,
                                      nu=1e-3, dtype="float64")
    mesh = jmesh({"ensemble": 8})
    jw, _ = jroll(jcfg, jinit(jcfg, w0s, mesh))
    close(w_hat, np.asarray(jw), 1e-10)
    energies = [r["spectral_ensemble"]["energy"] for r in g.results]
    assert len(set(energies)) == 1 and energies[0] > 0
    assert abs(energies[0] - float(jenergy(jcfg, jw))) <= 1e-12
    counts = g.results[0]["spectral_ensemble"]["all"]
    assert counts == {"all_reduce": 1, "all_reduce@ensemble": 1}


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_ensemble_fd_rollout_matches_members(request, n_ranks):
    """tests/test_parallel.py:145: a batch of chorin_fd (dst) rollouts over
    the ensemble ranks; each member equals its single rollout bitwise and
    the JAX ensemble within 1e-12."""
    import jax
    import jax.numpy as jnp
    from ns_tpu.core.bc import dirichlet, neumann
    from ns_tpu.parallel import make_mesh as jmesh
    from ns_tpu.parallel.ensemble import ensemble_fd_rollout as jens
    from ns_tpu.solvers import chorin_fd as jchorin
    g = gang_of(request, n_ranks)
    cfg = chorin_cfg()
    u_bc, v_bc, p_bc = cavity_bcs(cfg.dx, cfg.dy)
    step = chorin_fd.make_step(cfg, u_bc, v_bc, p_bc, dtype=torch.float64,
                               device="cpu")
    z = np.zeros((cfg.nx, cfg.ny))
    got = {f: g.field("fd_ensemble", f) for f in "uvp"}
    jcfg = jchorin.ChorinFDConfig(nt=4, nx=24, ny=24, dt=1e-3, rho=1.0,
                                  nu=0.1, beta=1.25, method="semi_implicit",
                                  pressure_mode="dst")
    ju = [dirichlet(0, "left"), dirichlet(1, "right"),
          dirichlet(0, "top"), dirichlet(0, "bottom")]
    jv = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    jp = [dirichlet(0, "top"), neumann(0, "bottom", cfg.dx, cfg.dy),
          neumann(0, "left", cfg.dx, cfg.dy),
          neumann(0, "right", cfg.dx, cfg.dy)]
    jstep = jchorin.make_step(jcfg, ju, jv, jp, dtype=jnp.float64)
    jmembers = [jchorin.init_state(jcfg, u0, z, z, ju, jv, jp,
                                   dtype=jnp.float64)
                for u0 in chorin_members(cfg)]
    jbatch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jmembers)
    jout = jens(jstep, jbatch, jcfg.nt, jmesh({"ensemble": 4},
                                              devices=jax.devices()[:4]))
    for f in "uvp":
        np.testing.assert_array_equal(got[f],
                                      g.field("fd_ensemble", "single_" + f))
    for i, u0 in enumerate(chorin_members(cfg)):
        s = chorin_fd.init_state(cfg, u0, z, z, u_bc, v_bc, p_bc,
                                 dtype=torch.float64, device="cpu")
        for _ in range(cfg.nt):
            s = step(s)
        for f in "uvp":
            close(got[f][i], getattr(s, f).numpy(), 1e-12)
            close(got[f][i], np.asarray(getattr(jout, f)[i]), 1e-12)


def test_every_rank_ran_every_scenario(gang2, gang4):
    """Each rank of both gangs reports every scenario of its world (a rank
    that failed, or imported jax or ns_tpu, fails its gang)."""
    for g in (gang2, gang4):
        names = set(_scenarios(g.world))
        assert all(set(r) == names for r in g.results)
