"""The sharded chorin_fd, chorin_spectral and spectral3d solvers on the
card, each against the single-device port on the same card.

Run it as one rank of a gang (NCCL, a world of 1 on one card):

    python -m ns_tpu_torch.launch --nprocs 1 --platform cuda -- \\
        python tools/torch_sharded_solvers.py

It prints one line, "SHARDED " and a JSON object: for each
run the largest error against its reference beside the bound, the
sharded and the single-device steps/s (one timed rollout each, after a
one-step warm-up; set-up apart), the kernels the sharded run launched
(none: the sharded paths are plain torch and cuBLAS), and the collective
counts a step against the JAX budgets (tests/test_collectives.py).
`chip_smoke.py` runs it and checks every number.

Runs and bounds (the chip_smoke docstring's):
  - chorin_fd, 1024^2 float32 (dt 1e-5, nu 0.01, the main runs'
    physics): explicit and the corrected semi-implicit predictor with the
    red-black SOR (nit 200, sor_tol 5e-6), nt 10, against the
    single-device port's plain route (`plain_route`: the SOR by K1's twin,
    `ops/poisson.py::sor_redblack`, whose gate is the JAX while_loop's, a
    sweep, as the sharded gate is; the explicit predictor by K3's twin)
    within 1e-3 of each field's max (the docstring's bound where a
    converged gate may stop a sweep apart); beside it, unbounded, the
    error against the kernel route (K4 + K3), whose gate runs every 8
    sweeps: where the SOR does not meet its tolerance, K4 takes 200 sweeps
    where the JAX gate stops at 199; dst nt 20 and helmholtz + dst nt 10
    within 1e-4 of max; explicit at 256^2 in float64 at a fixed sweep
    count (sor_tol 0, nit 65: 64 sweeps on both routes) against the kernel
    route within 1e-10 absolute;
  - chorin_spectral corrected 1024^2 float64 at 'highest' (dt 1e-6, the
    Chebyshev phase's), nt 10, against the dense engine, within 1e-10 of
    each field's max; both set-ups timed;
  - spectral3d Taylor-Green 256^3 float32 compact, 'highest' and
    'default': make_sharded_rollout3d nt 8 and make_sharded_simulate3d nt
    4 against the plain compact route (fused off), within 1e-5 of max|u|
    at 'highest' and 2e-3 at 'default' (ROADMAP section 3), and whether
    bitwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from ns_tpu_torch.cli.run_solver import cavity_bcs
from ns_tpu_torch.core.state import FlowState, rollout
from ns_tpu_torch.ops import kernels, poisson
from ns_tpu_torch.ops.kernels import momentum_kernels
from ns_tpu_torch.parallel import (chorin_fd_sharded,
                                   chorin_spectral_sharded,
                                   spectral3d_sharded)
from ns_tpu_torch.parallel import distributed as dist
from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
from ns_tpu_torch.parallel.mesh import shard
from ns_tpu_torch.solvers import chorin_fd, chorin_spectral
from ns_tpu_torch.solvers import spectral3d as s3

# grid sizes (a CPU rehearsal sets smaller ones)
N_FD, N_FD64, N_CHEB, N_3D = 1024, 256, 1024, 256
FD_PHYSICS = dict(dt=1e-5, nu=0.01)
F32, F64 = torch.float32, torch.float64


def fd_table():
    """label, config, dtype, bound, whether the bound is of the max."""
    n = dict(nx=N_FD, ny=N_FD)
    return [
        (f"explicit redblack {N_FD}^2", dict(method="explicit", nt=10,
                                             nit=200, **n), F32, 1e-3, True),
        (f"semi_implicit corrected redblack {N_FD}^2", dict(
            method="semi_implicit", quirk_compat=False, nt=10, nit=200, **n),
         F32, 1e-3, True),
        (f"semi_implicit dst {N_FD}^2", dict(
            method="semi_implicit", pressure_mode="dst", nt=20, **n), F32,
         1e-4, True),
        (f"helmholtz dst {N_FD}^2", dict(
            method="helmholtz", quirk_compat=False, pressure_mode="dst",
            nt=10, **n), F32, 1e-4, True),
        (f"explicit redblack {N_FD64}^2 float64 64 sweeps", dict(
            method="explicit", nt=10, nit=65, sor_tol=0.0, nx=N_FD64,
            ny=N_FD64), F64, 1e-10, False)]


CHEB = dict(nt=10, dt=1e-6, quirk_compat=False,
            deflate_pressure_nullspace=True, parity_split=False,
            matmul_precision="highest")
CHEB_BOUND = 1e-10
S3_BOUND = {"highest": 1e-5, "default": 2e-3}
# the JAX budgets a step (tests/test_collectives.py)
BUDGETS = {"chorin_fd redblack": {"collective_permute": 24,
                                  "all_reduce": 1},
           "chorin_fd dst": {"collective_permute": 22, "all_to_all": 2},
           "chorin_spectral": {"all_gather": 10, "all_reduce": 8},
           "spectral3d rollout": {"all_to_all": 6},
           "spectral3d simulate": {"all_to_all": 6}}


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def kinds(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if "@" not in k}


def launched(fn):
    """fn()'s result and the kernels it launched."""
    before = kernels.launch_counts()
    out = fn()
    after = kernels.launch_counts()
    return out, sorted(k for k in after if after[k] > before.get(k, 0))


def rel_err(got, want, relative: bool) -> float:
    err = 0.0
    for g, w in zip(got, want):
        d = float((g - w).abs().max())
        err = max(err, d / float(w.abs().max()) if relative else d)
    return err


@contextlib.contextmanager
def plain_route():
    """chorin_fd's single-device step on its plain route while inside:
    the SOR by `ops/poisson.py::sor_redblack` (K1's twin: the per-sweep
    gate of the JAX while_loop) at every grid, the explicit predictor by
    K3's twin. The step looks these names up when it runs."""
    names = ("sor_redblack_packed_multiblock", "sor_redblack_multiblock",
             "momentum_explicit_fused")
    saved = {n: getattr(chorin_fd, n) for n in names}
    sor = (lambda p, c, dx, dy, beta, tol, nit, k=8:  # noqa: E731
           poisson.sor_redblack(p, c, dx, dy, beta, tol, nit))
    chorin_fd.sor_redblack_packed_multiblock = sor
    chorin_fd.sor_redblack_multiblock = sor
    chorin_fd.momentum_explicit_fused = momentum_kernels.momentum_explicit
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(chorin_fd, n, f)


def fd_state(cfg, dtype, dev):
    bcs = cavity_bcs(cfg.dx, cfg.dy)
    z = np.zeros((cfg.nx, cfg.ny))
    return chorin_fd.init_state(cfg, z, z, z, *bcs, dtype=dtype,
                                device=dev), bcs


def blocks(sharding, state):
    return FlowState(*(shard(sharding, getattr(state, f)).local for f in
                       ("u", "v", "p", "u_prev", "v_prev")))


def fd_runs(mesh, dev) -> dict:
    out = {}
    for label, kw, dtype, bound, relative in fd_table():
        cfg = chorin_fd.ChorinFDConfig(**kw, **FD_PHYSICS)
        s0, bcs = fd_state(cfg, dtype, dev)
        step = chorin_fd.make_step(cfg, *bcs, dtype=dtype, device=dev)
        step(s0)
        want, t_single = timed(lambda: rollout(step, s0, cfg.nt))
        sstep, sharding = chorin_fd_sharded.make_sharded_step(
            cfg, *bcs, mesh, dtype=dtype)
        st = blocks(sharding, s0)
        sstep(st)
        reset_counts()
        (got, t_sharded), ran = launched(
            lambda: timed(lambda: rollout(sstep, st, cfg.nt)))
        out[label] = {
            "err": rel_err(got, want, relative), "bound": bound,
            "relative_to_max": relative, "kernels_launched": ran,
            "steps_per_s": cfg.nt / t_sharded,
            "single_device_steps_per_s": cfg.nt / t_single,
            "counts": kinds(COUNTS)}
        if dtype == F32 and cfg.pressure_mode == "redblack":
            # held to the plain route; the kernel route's error beside it
            with plain_route():
                plain, t_plain = timed(lambda: rollout(step, s0, cfg.nt))
            out[label].update(
                err=rel_err(got, plain, relative),
                err_vs_kernel_route=rel_err(got, want, relative),
                plain_route_steps_per_s=cfg.nt / t_plain)
    # one step's collectives at one sweep (nit 2), the JAX budget's sites
    for label, mode in (("chorin_fd redblack", "redblack"),
                        ("chorin_fd dst", "dst")):
        cfg = chorin_fd.ChorinFDConfig(nt=1, nit=2, nx=N_FD, ny=N_FD,
                                       pressure_mode=mode, **FD_PHYSICS)
        s0, bcs = fd_state(cfg, F32, dev)
        sstep, sharding = chorin_fd_sharded.make_sharded_step(cfg, *bcs,
                                                              mesh)
        reset_counts()
        sstep(blocks(sharding, s0))
        out[label + " counts a step"] = kinds(COUNTS)
    return out


def cheb_run(mesh, dev) -> dict:
    cfg = chorin_spectral.ChorinSpectralConfig(nx=N_CHEB, ny=N_CHEB, **CHEB)
    u_bc, v_bc, _ = cavity_bcs(2.0 / (cfg.nx - 1), 2.0 / (cfg.ny - 1))
    z = np.zeros((cfg.nx, cfg.ny))
    s0 = chorin_spectral.init_state(cfg, z, z, z, u_bc, v_bc, device=dev)
    (sstep, sharding), setup_sharded = timed(
        lambda: chorin_spectral_sharded.make_sharded_step(cfg, u_bc, v_bc,
                                                          mesh))
    step, setup_single = timed(lambda: chorin_spectral.make_step(
        cfg, u_bc, v_bc, device=dev))
    step(s0)
    want, t_single = timed(lambda: chorin_spectral.simulate(cfg, s0, step))
    st = blocks(sharding, s0)
    sstep(st)
    reset_counts()
    (got, t_sharded), ran = launched(
        lambda: timed(lambda: rollout(sstep, st, cfg.nt)))
    return {"err": rel_err(got, want, True), "bound": CHEB_BOUND,
            "kernels_launched": ran, "steps_per_s": cfg.nt / t_sharded,
            "single_device_steps_per_s": cfg.nt / t_single,
            "setup_s": setup_sharded, "single_device_setup_s": setup_single,
            "counts_a_step": {k: v / cfg.nt
                              for k, v in kinds(COUNTS).items()}}


def s3_runs(mesh, dev) -> dict:
    out = {}
    for prec in ("highest", "default"):
        cfg = s3.Spectral3DConfig(nt=8, nx=N_3D, ny=N_3D, nz=N_3D,
                                  transform="matmul", matmul_precision=prec)
        u0 = torch.as_tensor(s3.taylor_green_velocity(cfg),
                             dtype=cfg.real_dtype, device=dev)
        # the single-device plain compact route (fused off), its
        # constants built before the timed rollout as the sharded one's
        build = s3._carry_builder(cfg, dev)
        step, _ = s3.make_step(cfg, dev)
        # fields_from_hat's inverse, built once
        inv = s3.make_transforms(s3._extract_cfg(cfg), dev)[1]
        roll, sharding = spectral3d_sharded.make_sharded_rollout3d(cfg,
                                                                   mesh)
        x = shard(sharding, u0)
        # warm-ups: one step of each side (library handles, plans)
        inv(s3._advance(step, build(u0), 1)[0])
        spectral3d_sharded.make_sharded_rollout3d(
            dataclasses.replace(cfg, nt=1), mesh)[0](x)
        want, t_single = timed(lambda: inv(
            s3._advance(step, build(u0), cfg.nt)[0]))
        reset_counts()
        (got, t_sharded), ran = launched(lambda: timed(lambda: roll(x)))
        counts = kinds(COUNTS)
        out[f"rollout {prec}"] = {
            "err": rel_err([got.local], [want], True),
            "bitwise": bool(torch.equal(got.local, want)),
            "bound": S3_BOUND[prec], "kernels_launched": ran,
            "steps_per_s": cfg.nt / t_sharded,
            "single_device_steps_per_s": cfg.nt / t_single,
            "counts": counts,
            "sites": counts["all_to_all"] - 2 * (cfg.nt - 1)}
        del want, got
        cfg4 = dataclasses.replace(cfg, nt=4)

        def frames():
            c = build(u0)
            seq = []
            for _ in range(cfg4.nt):
                c, u_new = step(c)
                seq.append(inv(u_new))
            return torch.stack(seq)

        want, t_single = timed(frames)
        sim, sharding = spectral3d_sharded.make_sharded_simulate3d(cfg4,
                                                                   mesh)
        x = shard(sharding, u0)
        reset_counts()
        (got, t_sharded), ran = launched(lambda: timed(lambda: sim(x)))
        counts = kinds(COUNTS)
        out[f"simulate {prec}"] = {
            "err": rel_err([got.local], [want], True),
            "bitwise": bool(torch.equal(got.local, want)),
            "bound": S3_BOUND[prec], "kernels_launched": ran,
            "steps_per_s": cfg4.nt / t_sharded,
            "single_device_steps_per_s": cfg4.nt / t_single,
            "counts": counts,
            "sites": counts["all_to_all"] - 3 * (cfg4.nt - 1)}
        del want, got, x
        torch.cuda.empty_cache()
    return out


def main():
    t0 = time.perf_counter()
    dev = dist.initialize_from_env()
    mesh = dist.make_global_mesh({"x": dist.process_count()})
    init_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    parts, seconds = {}, {}
    for name, fn in (("chorin_fd", fd_runs), ("chorin_spectral", cheb_run),
                     ("spectral3d", s3_runs)):
        t0 = time.perf_counter()
        parts[name] = fn(mesh, dev)
        seconds[name] = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    out = {"world": dist.process_count(),
           "backend": torch.distributed.get_backend(),
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "process_group_init_s": init_s, "seconds": seconds,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
           else None, "budgets": BUDGETS, **parts}
    dist.barrier("sharded_done")
    dist.shutdown()
    print("SHARDED " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
