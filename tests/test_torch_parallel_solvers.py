"""The port's sharded chorin_fd, chorin_spectral and spectral3d solvers
(ns_tpu_torch.parallel) on gloo gangs of 2 and 4 CPU ranks, against the
single-device port and the JAX package's sharded functions.

One gang a rank count (a module fixture, both run at the same time): each
rank runs every scenario below on its block, writes its shards with
`save_array_shards` and its collective counts and caught errors as JSON,
and the tests compare what the parent reassembles. Every rank asserts
that neither jax nor ns_tpu was imported (this file imports them inside
test bodies only). Bounds are the JAX tests' own, float64:
tests/test_chorin_fd_sharded.py (1e-12; dst and helmholtz 1e-10, p
1e-9, at 32^2 here, where the JAX suite's 40^2 cases are slow),
tests/test_chorin_spectral_sharded.py (1e-11) and
tests/test_spectral3d_sharded.py (1e-12 of max).

Collective counts are held to the JAX budgets (tests/test_collectives.py)
as tests/test_torch_parallel.py reads them: the port counts calls, JAX
counts sites, so a loop's body is read from one pass of it.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from ns_tpu_torch.cli.run_solver import cavity_bcs
from ns_tpu_torch.core.bc import dirichlet, neumann
from ns_tpu_torch.core.state import FlowState
from ns_tpu_torch.ops import cheb
from ns_tpu_torch.parallel import chorin_fd_sharded as cfs
from ns_tpu_torch.parallel import chorin_spectral_sharded as css
from ns_tpu_torch.parallel import distributed as dist
from ns_tpu_torch.parallel import make_mesh
from ns_tpu_torch.parallel import spectral3d_sharded as s3s
from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
from ns_tpu_torch.parallel.mesh import Sharding, shard
from ns_tpu_torch.solvers import chorin_fd
from ns_tpu_torch.solvers import chorin_spectral as cs
from ns_tpu_torch.solvers import spectral3d as s3

GANG_TIMEOUT = 120
F64 = torch.float64


# ---------------------------------------------------------------------------
# configurations (shared by the ranks and the parent)
# ---------------------------------------------------------------------------

def fd_cfg(method="semi_implicit", mode="redblack", n=40, nit=100, **kw):
    kw.setdefault("quirk_compat", method != "helmholtz")
    return chorin_fd.ChorinFDConfig(nt=4, nit=nit, nx=n, ny=n, dt=1e-3,
                                    rho=1.0, nu=0.1, beta=1.25,
                                    method=method, pressure_mode=mode, **kw)


FD_CASES = {  # scenario -> config
    "explicit": fd_cfg("explicit"),
    "semi": fd_cfg("semi_implicit"),
    "dst": fd_cfg("semi_implicit", "dst", n=32),
    "helmholtz": fd_cfg("helmholtz", "dst", n=32),
}
RECT = chorin_fd.ChorinFDConfig(nt=3, nit=80, nx=24, ny=16, dt=1e-3,
                                rho=1.0, nu=0.1, beta=1.25,
                                method="semi_implicit", quirk_compat=False)


def cheb_case(kind):
    """(cfg, u0, v0, p0, u_bc, v_bc) of tests/test_chorin_spectral_sharded
    .py's Dirichlet, Neumann and pressure-ring cases."""
    n = 32
    cfg = cs.ChorinSpectralConfig(
        nt={"dirichlet": 5, "neumann": 4, "ring": 3}[kind], nx=n, ny=n,
        dt=1e-3, rho=1.0, nu=0.1, quirk_compat=False,
        deflate_pressure_nullspace=True)
    x = cheb.gauss_lobatto(n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    v_bc = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    z = np.zeros((n, n))
    if kind == "neumann":
        u_bc = [neumann(0, "left", 0.1, 0.1), neumann(0, "right", 0.1, 0.1),
                dirichlet(0, "top"), dirichlet(0, "bottom")]
        return cfg, 1.0 - Y**2, z, z, u_bc, v_bc
    u0 = (1 - X**2) * (1 - Y**2)
    if kind == "ring":
        p0 = np.random.default_rng(0).normal(size=(n, n))
        return cfg, u0, z, p0, v_bc, v_bc
    u_bc = [dirichlet(0, "left"), dirichlet(1, "right"),
            dirichlet(0, "top"), dirichlet(0, "bottom")]
    return cfg, u0, z, z, u_bc, v_bc


def s3_cfg(**kw):
    return s3.Spectral3DConfig(dtype="float64", transform="matmul",
                               matmul_precision="highest", **kw)


def s3_case(kind):
    """(cfg, u0) of tests/test_spectral3d_sharded.py's cases (ens: u0
    stacks two members)."""
    if kind in ("none", "kolmogorov"):
        cfg = s3_cfg(nt=5, nx=16, ny=12, nz=12, dt=1e-3, nu=1e-3,
                     forcing=kind, forcing_k=2, forcing_amp=0.05)
        return cfg, s3.random_solenoidal_velocity(cfg, seed=0, k_peak=2.0)
    if kind == "sim":
        cfg = s3_cfg(nt=4, nx=8, ny=12, nz=8, dt=1e-3, nu=5e-3)
        return cfg, s3.random_solenoidal_velocity(cfg, seed=1, k_peak=1.5)
    cfg = s3_cfg(nt=3, nx=8, ny=12, nz=8, dt=1e-3, nu=1e-3)
    return cfg, np.stack([s3.random_solenoidal_velocity(
        cfg, seed=s, k_peak=1.5) for s in range(2)])


def fd_state(cfg, dtype=F64, device="cpu"):
    u_bc, v_bc, p_bc = cavity_bcs(cfg.dx, cfg.dy)
    z = np.zeros((cfg.nx, cfg.ny))
    return chorin_fd.init_state(cfg, z, z, z, u_bc, v_bc, p_bc, dtype=dtype,
                                device=device), (u_bc, v_bc, p_bc)


def cheb_state(kind):
    cfg, u0, v0, p0, u_bc, v_bc = cheb_case(kind)
    return cfg, cs.init_state(cfg, u0, v0, p0, u_bc, v_bc,
                              device="cpu"), u_bc, v_bc


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _save(out, arrays):
    for name, arr in zip("uvp", arrays):
        dist.save_array_shards(out, name, arr)


def _fd(out, mesh, cfg):
    s0, bcs = fd_state(cfg)
    _save(out, cfs.simulate(cfg, s0, *bcs, mesh, dtype=F64))


def _fd_step_counts(mesh, cfg):
    """One step's collective counts."""
    s0, bcs = fd_state(cfg)
    step, sharding = cfs.make_sharded_step(cfg, *bcs, mesh, dtype=F64)
    st = FlowState(*(shard(sharding, getattr(s0, f)) for f in
                     ("u", "v", "p", "u_prev", "v_prev")))
    reset_counts()
    step(st)
    return dict(COUNTS)


def _cheb(out, mesh, kind):
    cfg, s0, u_bc, v_bc = cheb_state(kind)
    _save(out, css.simulate(cfg, s0, u_bc, v_bc, mesh))


def _cheb_step_counts(mesh):
    cfg, s0, u_bc, v_bc = cheb_state("dirichlet")
    step, sharding = css.make_sharded_step(cfg, u_bc, v_bc, mesh)
    st = FlowState(*(shard(sharding, getattr(s0, f)) for f in
                     ("u", "v", "p", "u_prev", "v_prev")))
    reset_counts()
    step(st)
    return dict(COUNTS)


def _s3(out, mesh, kind, nt=None):
    """A 3D rollout (or simulate for 'sim'); its collective counts."""
    cfg, u0 = s3_case(kind)
    if nt is not None:
        cfg = dataclasses.replace(cfg, nt=nt)
    if kind == "sim":
        fn, sharding = s3s.make_sharded_simulate3d(cfg, mesh)
    else:
        fn, sharding = s3s.make_sharded_rollout3d(
            cfg, mesh, ens_axis="ensemble" if kind == "ens" else None)
    reset_counts()
    got = fn(shard(sharding, u0))
    counts = dict(COUNTS)
    if out is not None:
        dist.save_array_shards(out, "u", got)
    return counts


def _errors(mesh):
    """The validation errors' messages ('no error' where none was
    raised), each caught before any collective."""
    out = {}
    u_bc, v_bc, p_bc = cavity_bcs(0.1, 0.1)
    cases = {
        "fd_mode": lambda: cfs.make_sharded_step(
            fd_cfg(n=16, mode="gauss_seidel"), u_bc, v_bc, p_bc, mesh),
        "fd_divisible": lambda: cfs.make_sharded_step(
            chorin_fd.ChorinFDConfig(nx=16, ny=6, method="explicit"),
            u_bc, v_bc, p_bc, mesh),
        "fd_columns": lambda: cfs.make_sharded_step(
            chorin_fd.ChorinFDConfig(nx=16, ny=4, method="explicit"),
            u_bc, v_bc, p_bc, mesh),
        "fd_dst_rows": lambda: cfs.make_sharded_step(
            chorin_fd.ChorinFDConfig(nx=18, ny=16, pressure_mode="dst",
                                     quirk_compat=False),
            u_bc, v_bc, p_bc, mesh),
        "cheb_quirk": lambda: css.make_sharded_step(
            cs.ChorinSpectralConfig(nx=16, ny=16, quirk_compat=True),
            v_bc, v_bc, mesh),
        "cheb_divisible": lambda: css.make_sharded_step(
            cs.ChorinSpectralConfig(nx=16, ny=18, quirk_compat=False),
            v_bc, v_bc, mesh),
        "s3_fft": lambda: s3s.make_sharded_compact3d(
            s3.Spectral3DConfig(transform="fft"), mesh),
        "s3_divisible": lambda: s3s.make_sharded_compact3d(
            s3_cfg(nx=10), mesh),
    }
    for name, fn in cases.items():
        try:
            fn()
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    return out


def _scenarios(world):
    """name -> fn(out_dir) run on every rank of a gang of `world`."""
    x = lambda: make_mesh({"x": world})  # noqa: E731
    s = {f"fd_{k}": (lambda o, c=c: _fd(o, x(), c))
         for k, c in FD_CASES.items()}
    s.update({
        "cheb_dirichlet": lambda o: _cheb(o, x(), "dirichlet"),
        "s3_none": lambda o: _s3(o, x(), "none"),
    })
    if world == 2:
        s["s3_sim"] = lambda o: _s3(o, x(), "sim")
    if world == 4:
        s.update({
            "fd_rect": lambda o: _fd(o, x(), RECT),
            "cheb_neumann": lambda o: _cheb(o, x(), "neumann"),
            "cheb_ring": lambda o: _cheb(o, x(), "ring"),
            "s3_kolmogorov": lambda o: _s3(o, x(), "kolmogorov"),
            "s3_ens": lambda o: _s3(o, make_mesh({"ensemble": 2, "x": 2}),
                                    "ens"),
            "errors": lambda o: _errors(x()),
            "counts": lambda o: {
                # nit 2: one sweep; nit 3: two (the gate stays open)
                **{f"fd_{mode}_nit{nit}": _fd_step_counts(
                    x(), fd_cfg(mode=mode, n=32, nit=nit))
                   for mode in ("redblack", "dst") for nit in (2, 3)},
                "cheb": _cheb_step_counts(x()),
                **{f"s3_{kind}{nt}": _s3(None, x(), kind, nt)
                   for kind in ("none", "sim") for nt in (2, 3)}},
        })
    return s


def _gang_worker(rank, world, init, out):
    """One rank: every scenario of `world`, shards and counts under out."""
    assert "jax" not in sys.modules
    torch.set_num_threads(1)
    dist.initialize(init, world, rank, "cpu")
    results = {}
    for name, fn in _scenarios(world).items():
        results[name] = fn(os.path.join(out, name))
        dist.barrier()
    with open(os.path.join(out, f"results.{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.shutdown()
    assert "jax" not in sys.modules
    assert not any(m.split(".")[0] == "ns_tpu" for m in sys.modules)


def _start_gang(world, out):
    return torch.multiprocessing.start_processes(
        _gang_worker, args=(world, "file://" + os.path.join(out, "init"),
                            out),
        nprocs=world, join=False, start_method="spawn")


class Gang:
    def __init__(self, world, out):
        self.world, self.out = world, out
        self.results = [json.load(open(os.path.join(
            out, f"results.{r}.json"))) for r in range(world)]

    def field(self, scenario, name):
        return dist.assemble_shards(os.path.join(self.out, scenario), name)


class Gangs:
    """The gangs of 2 and 4 ranks, started at once; a test that asks for
    one (after computing its references) waits for it then."""

    def __init__(self, outs):
        self.outs = outs
        self.ctxs = {n: _start_gang(n, out) for n, out in outs.items()}
        self.deadline = time.monotonic() + GANG_TIMEOUT
        self.done = {}

    def __getitem__(self, n):
        if n not in self.done:
            ctx = self.ctxs[n]
            while not ctx.join(timeout=1):
                if time.monotonic() > self.deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f"a gang did not finish in "
                                       f"{GANG_TIMEOUT} s")
            self.done[n] = Gang(n, self.outs[n])
        return self.done[n]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    gangs = Gangs({n: str(tmp_path_factory.mktemp(f"sgang{n}"))
                   for n in (2, 4)})
    yield gangs
    for n in (2, 4):
        gangs[n]


# ---------------------------------------------------------------------------
# single-device and JAX references
# ---------------------------------------------------------------------------

def close(got, want, atol):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, err


def port_fd(cfg):
    s0, bcs = fd_state(cfg)
    return [a.numpy() for a in chorin_fd.simulate(cfg, s0, *bcs)]


def jax_mesh(shape):
    import jax
    from ns_tpu.parallel import make_mesh as jmesh
    n = int(np.prod(list(shape.values())))
    return jmesh(shape, devices=jax.devices()[:n])


def jax_bcs(bcs):
    """The JAX package's BCs of this package's list."""
    from ns_tpu.core.bc import BC as JBC
    return [JBC(b.kind, b.value, b.side, b.dx, b.dy) for b in bcs]


def jax_fd(cfg, n):
    import jax.numpy as jnp
    from ns_tpu.parallel import chorin_fd_sharded as jcfs
    from ns_tpu.solvers import chorin_fd as jfd
    jcfg = jfd.ChorinFDConfig(**{f.name: getattr(cfg, f.name) for f in
                                 dataclasses.fields(cfg)
                                 if f.name in jfd.ChorinFDConfig.
                                 __dataclass_fields__})
    bcs = [jax_bcs(b) for b in cavity_bcs(cfg.dx, cfg.dy)]
    z = np.zeros((cfg.nx, cfg.ny))
    s0 = jfd.init_state(jcfg, z, z, z, *bcs, dtype=jnp.float64)
    return [np.asarray(a) for a in jcfs.simulate(
        jcfg, s0, *bcs, jax_mesh({"x": n}), dtype=jnp.float64)]


def port_cheb(kind):
    cfg, s0, u_bc, v_bc = cheb_state(kind)
    step = cs.make_step(cfg, u_bc, v_bc, device="cpu")
    return [a.numpy() for a in cs.simulate(cfg, s0, step)]


def jax_cheb(kind, n):
    import jax.numpy as jnp
    from ns_tpu.parallel import chorin_spectral_sharded as jcss
    from ns_tpu.solvers import chorin_spectral as jcs
    cfg, u0, v0, p0, u_bc, v_bc = cheb_case(kind)
    jcfg = jcs.ChorinSpectralConfig(
        nt=cfg.nt, nx=cfg.nx, ny=cfg.ny, dt=cfg.dt, rho=cfg.rho, nu=cfg.nu,
        quirk_compat=False, deflate_pressure_nullspace=True)
    ub, vb = jax_bcs(u_bc), jax_bcs(v_bc)
    s0 = jcs.init_state(jcfg, u0, v0, p0, ub, vb, dtype=jnp.float64)
    return [np.asarray(a) for a in jcss.simulate(jcfg, s0, ub, vb,
                                                 jax_mesh({"x": n}))]


def port_s3(kind):
    cfg, u0 = s3_case(kind)
    if kind == "sim":
        carry = s3.init_from_velocity(cfg, u0, device="cpu")
        return s3.fields_from_hat(cfg, s3.simulate_hat(cfg, carry)).numpy()
    u0s = u0 if kind == "ens" else u0[None]
    out = [s3.fields_from_hat(cfg, s3.rollout_final(
        cfg, s3.init_from_velocity(cfg, u, device="cpu"))[0]).numpy()
        for u in u0s]
    return np.stack(out) if kind == "ens" else out[0]


def jax_s3(kind, shape):
    import jax
    import jax.numpy as jnp
    from ns_tpu.parallel import spectral3d_sharded as js3s
    from ns_tpu.solvers import spectral3d as js3
    cfg, u0 = s3_case(kind)
    jcfg = js3.Spectral3DConfig(
        nt=cfg.nt, nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, dt=cfg.dt, nu=cfg.nu,
        forcing=cfg.forcing, forcing_k=cfg.forcing_k,
        forcing_amp=cfg.forcing_amp, dtype="float64", transform="matmul",
        matmul_precision="highest")
    mesh = jax_mesh(shape)
    if kind == "sim":
        fn, sh = js3s.make_sharded_simulate3d(jcfg, mesh, axis="x")
    else:
        fn, sh = js3s.make_sharded_rollout3d(
            jcfg, mesh, axis="x",
            ens_axis="ensemble" if kind == "ens" else None)
    return np.asarray(fn(jax.device_put(jnp.asarray(u0), sh)))


# ---------------------------------------------------------------------------
# tests: chorin_fd_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["explicit", "semi"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_chorin_fd_matches_single_device(gangs, case, n_shards):
    """tests/test_chorin_fd_sharded.py:36: the all-reduce gated SOR takes
    the single-device sweeps, so the rollouts agree to float64 roundoff."""
    cfg = FD_CASES[case]
    for name, ref, j in zip("uvp", port_fd(cfg), jax_fd(cfg, n_shards)):
        got = gangs[n_shards].field(f"fd_{case}", name)
        close(got, ref, 1e-12)
        close(got, j, 1e-12)


def test_sharded_chorin_fd_corrected_rectangular(gangs):
    """quirk_compat=False on 24x16: the all_gather corrected y-sweep."""
    for name, ref, j in zip("uvp", port_fd(RECT), jax_fd(RECT, 4)):
        got = gangs[4].field("fd_rect", name)
        close(got, ref, 1e-12)
        close(got, j, 1e-12)


@pytest.mark.parametrize("case", ["dst", "helmholtz"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_chorin_fd_direct_solves(gangs, case, n_shards):
    """tests/test_chorin_fd_sharded.py:92, :117: the padded-basis DST
    pressure and the helmholtz predictor on two all_to_all transposes;
    u, v within 1e-10, p within 1e-9."""
    cfg = FD_CASES[case]
    for name, ref, j in zip("uvp", port_fd(cfg), jax_fd(cfg, n_shards)):
        bound = 1e-9 if name == "p" else 1e-10
        got = gangs[n_shards].field(f"fd_{case}", name)
        close(got, ref, bound)
        close(got, j, bound)


@pytest.mark.parametrize("name,needle", [
    ("fd_mode", "'redblack' or 'dst' only"),
    ("fd_divisible", "ny=6 not divisible by mesh axis size 4"),
    ("fd_columns", "need at least 2 columns per shard"),
    ("fd_dst_rows", "the DST paths need nx=18 divisible"),
    ("cheb_quirk", "corrected mode only"),
    ("cheb_divisible", "ny=18 not divisible by mesh axis size 4"),
    ("s3_fft", "transform='matmul'"),
    ("s3_divisible", "nx=10 not divisible by 4 shards")])
def test_sharded_solvers_validate_as_jax_does(gangs, name, needle):
    """The JAX files' refusals, with their messages, on 4 ranks."""
    for r in range(4):
        assert needle in gangs[4].results[r]["errors"][name]


def test_chorin_fd_collective_budgets(gangs):
    """tests/test_collectives.py:117: red-black SOR = 24
    collective_permutes (12 halo exchanges) + ONE all_reduce gate at the
    sweep site; each more sweep 4 permutes + 1 all_reduce; 'dst' drops
    the gate and the sweep for 2 all_to_all and 22 permutes."""
    c = gangs[4].results[0]["counts"]
    one, two = c["fd_redblack_nit2"], c["fd_redblack_nit3"]
    assert {k: v for k, v in one.items() if "@" not in k} == {
        "collective_permute": 24, "all_reduce": 1}
    assert two["collective_permute"] - one["collective_permute"] == 4
    assert two["all_reduce"] - one["all_reduce"] == 1
    for nit in (2, 3):
        assert {k: v for k, v in c[f"fd_dst_nit{nit}"].items()
                if "@" not in k} == {"collective_permute": 22,
                                     "all_to_all": 2}


# ---------------------------------------------------------------------------
# tests: chorin_spectral_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_chorin_spectral_matches_single_device(gangs, n_shards):
    """tests/test_chorin_spectral_sharded.py:22: the corrected mode's
    all_gather y-contractions against the dense single-device engine."""
    for name, ref, j in zip("uvp", port_cheb("dirichlet"),
                            jax_cheb("dirichlet", n_shards)):
        got = gangs[n_shards].field("cheb_dirichlet", name)
        close(got, ref, 1e-11)
        close(got, j, 1e-11)


def test_sharded_chorin_spectral_neumann(gangs):
    """Neumann x-faces sharded too (u and v, as the JAX test checks)."""
    for name, ref, j in zip("uv", port_cheb("neumann"),
                            jax_cheb("neumann", 4)):
        got = gangs[4].field("cheb_neumann", name)
        close(got, ref, 1e-11)
        close(got, j, 1e-11)


def test_sharded_chorin_spectral_keeps_pressure_ring(gangs):
    """A nonzero initial boundary ring of p survives as the single-device
    step's p[1:-1, 1:-1] = Q leaves it."""
    ref, want = port_cheb("ring"), jax_cheb("ring", 4)
    for i, name in ((2, "p"), (0, "u")):
        got = gangs[4].field("cheb_ring", name)
        close(got, ref[i], 1e-11)
        close(got, want[i], 1e-11)
        if name == "p":
            ring = np.random.default_rng(0).normal(size=(32, 32))
            np.testing.assert_array_equal(
                got[:, 0], np.broadcast_to(ring[0], got[:, 0].shape))


def test_chorin_spectral_gather_budget(gangs):
    """tests/test_collectives.py:154: 10 all_gathers (the y-contractions)
    and 8 all_reduces (the y-edge reconstructions) a step, no halo."""
    c = gangs[4].results[0]["counts"]["cheb"]
    assert {k: v for k, v in c.items() if "@" not in k} == {
        "all_gather": 10, "all_reduce": 8}


# ---------------------------------------------------------------------------
# tests: spectral3d_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("forcing,n_shards", [("none", 2), ("none", 4),
                                              ("kolmogorov", 4)])
def test_sharded_spectral3d_rollout(gangs, forcing, n_shards):
    """tests/test_spectral3d_sharded.py:29: the final velocity within
    1e-12 of its max, unforced and Kolmogorov-forced."""
    ref = port_s3(forcing)
    atol = 1e-12 * np.abs(ref).max()
    got = gangs[n_shards].field(f"s3_{forcing}", "u")
    close(got, ref, atol)
    close(got, jax_s3(forcing, {"x": n_shards}), atol)


def test_sharded_spectral3d_simulate_stacks(gangs):
    ref = port_s3("sim")
    atol = 1e-12 * np.abs(ref).max()
    got = gangs[2].field("s3_sim", "u")
    assert got.shape == (4, 3, 8, 12, 8)
    close(got, ref, atol)
    close(got, jax_s3("sim", {"x": 2}), atol)


def test_sharded_spectral3d_ensemble_axis(gangs):
    """Two members over an ensemble x spatial (2 x 2) mesh, each its own
    rollout; the ensemble axis never communicates."""
    ref = port_s3("ens")
    atol = 1e-12 * np.abs(ref).max()
    got = gangs[4].field("s3_ens", "u")
    close(got, ref, atol)
    close(got, jax_s3("ens", {"ensemble": 2, "x": 2}), atol)
    counts = gangs[4].results[3]["s3_ens"]
    assert set(counts) == {"all_to_all", "all_to_all@x"}


def test_spectral3d_one_all_to_all_per_transform(gangs):
    """tests/test_collectives.py:169: rollout = 3 init sites + 2 a step +
    1 output = 6; simulate = 3 init + 3 a step = 6; all_to_all only."""
    c = gangs[4].results[1]["counts"]
    for kind, per_step in (("none", 2), ("sim", 3)):
        two, three = (c[f"s3_{kind}{nt}"] for nt in (2, 3))
        assert set(two) == {"all_to_all", "all_to_all@x"}
        step = three["all_to_all"] - two["all_to_all"]
        assert step == per_step
        assert two["all_to_all"] - step == 6


# ---------------------------------------------------------------------------
# tests: a world of 1 (no process group)
# ---------------------------------------------------------------------------

def test_world_of_one_is_the_single_device_solver():
    """On a mesh of one rank the SOR paths and the 3D rollout are the
    single-device solvers bitwise; the DST and Chebyshev paths (padded
    GEMM shapes) within 1e-12."""
    mesh = make_mesh({"x": 1}, device_type="cpu")
    for case, exact in (("explicit", True), ("dst", False)):
        cfg = fd_cfg(case.replace("dst", "semi_implicit"),
                     "dst" if case == "dst" else "redblack", n=24)
        s0, bcs = fd_state(cfg)
        got = cfs.simulate(cfg, s0, *bcs, mesh, dtype=F64)
        for g, want in zip(got, chorin_fd.simulate(cfg, s0, *bcs)):
            assert torch.equal(g.local, want) if exact else float(
                (g.local - want).abs().max()) <= 1e-12
    cfg, s0, u_bc, v_bc = cheb_state("dirichlet")
    got = css.simulate(cfg, s0, u_bc, v_bc, mesh)
    for g, want in zip(got, port_cheb("dirichlet")):
        assert float(np.abs(g.local.numpy() - want).max()) <= 1e-12
    cfg, u0 = s3_case("none")
    roll, sharding = s3s.make_sharded_rollout3d(cfg, mesh)
    np.testing.assert_array_equal(roll(shard(sharding, u0)).local.numpy(),
                                  port_s3("none"))


def test_sharded_chorin_fd_float32_gate_on_one_rank():
    """float32 with a tolerance the sweeps reach: the gate closes before
    nit in every step, the frozen sweeps up to the next host read change
    nothing, and the sharded step takes the single-device (K1 twin)
    sweeps, bitwise."""
    cfg = chorin_fd.ChorinFDConfig(nt=3, nit=200, nx=24, ny=24, dt=1e-3,
                                   nu=0.1, method="explicit", sor_tol=1e-4)
    mesh = make_mesh({"x": 1}, device_type="cpu")
    s0, bcs = fd_state(cfg, dtype=torch.float32)
    reset_counts()
    got = cfs.simulate(cfg, s0, *bcs, mesh)
    sweeps = COUNTS["all_reduce"]
    assert sweeps < 3 * (cfg.nit - 1)      # the gate closed in every step
    for g, want in zip(got, chorin_fd.simulate(cfg, s0, *bcs)):
        assert torch.equal(g.local, want)
    assert Sharding(mesh, (None, None, "x")).spec == got[0].sharding.spec
