"""Run a solver rollout with the torch port and save the reference-format
npz.

Port of `ns_tpu/cli/run_solver.py`, with the same presets, flags and
defaults:

  direct_fd        — nt=200 nit=50 50x50 lid-driven cavity (--pressure-mode
                     jacobi|exact)
  chorin_fd        — nt=200 nit=200 51x51, semi_implicit (--method
                     explicit|helmholtz for the other modes;
                     --pressure-mode redblack|gauss_seidel|multigrid|cg|dst)
  chorin_spectral  — the reference's 51x51 Dirichlet cavity (Chebyshev
                     collocation; unstable by design: it overflows within
                     a few steps); --corrected for the stable operator mode
  taylor_green     — 2D periodic Taylor-Green vortex (256^2 by default)
  decaying_turbulence — 2D periodic decaying turbulence at --nx (--seed;
                     --n-traj N stacks N seeds as (N, nt, nx, ny))
  taylor_green_3d  — 3D Taylor-Green vortex (nu defaults to 1/1600); the
                     npz carries u/v/w/p
  decaying_turbulence_3d — 3D isotropic decaying turbulence (--seed)

The cavity and 2D periodic npz hold u, v, p of shape (nt, nx, ny), the
layout the JAX trainer reads. --guard runs a cavity family under the
divergence guard (utils/guard.py: the state freezes at the last good step
and the first bad step is reported); --progress runs the rollout in
--chunk-step chunks with a progress bar (utils/progress.py); --stream-dir
streams the frames to .npy files a chunk at a time (io/streaming.py: u/v/p
for the cavity families, u/v/p/w for the 2D periodic ones) instead of
writing the npz; all three as the JAX CLI. --dist (2D periodic families,
under `python -m ns_tpu_torch.launch`) shards the rollout over the ranks
and writes per-rank shard files plus, unless --no-assemble, the npz.
Rollouts run on the card; a machine
without one needs --device cpu (without it the command exits with an
error). The summary reports the set-up time (building the system) apart
from the total.

Examples:
  python -m ns_tpu_torch.cli.run_solver direct_fd --out data.npz
  python -m ns_tpu_torch.cli.run_solver chorin_fd --method explicit
  python -m ns_tpu_torch.cli.run_solver chorin_fd --device cpu --nt 5
  python -m ns_tpu_torch.cli.run_solver chorin_fd --pressure-mode dst
  python -m ns_tpu_torch.cli.run_solver direct_fd --pressure-mode exact
  python -m ns_tpu_torch.cli.run_solver taylor_green_3d --nx 256 --nt 8 \
      --transform matmul --precision default
  python -m ns_tpu_torch.cli.run_solver taylor_green_3d --device cpu --nx 16
  python -m ns_tpu_torch.cli.run_solver decaying_turbulence --nx 1024 \
      --nt 100 --transform matmul --compact --precision default
  python -m ns_tpu_torch.cli.run_solver taylor_green --device cpu --nx 32
  python -m ns_tpu_torch.cli.run_solver chorin_spectral --guard
  python -m ns_tpu_torch.cli.run_solver chorin_spectral --corrected \
      --nx 1024 --nt 20 --dt 1e-6 --guard
"""

import argparse
import os
import time

import numpy as np
import torch

from ns_tpu_torch.core.bc import dirichlet, neumann
from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.io.npz import save_rollout

_FAMILIES = ["direct_fd", "chorin_fd", "chorin_spectral", "taylor_green",
             "decaying_turbulence", "taylor_green_3d",
             "decaying_turbulence_3d"]
_2D = ("taylor_green", "decaying_turbulence")
_3D = ("taylor_green_3d", "decaying_turbulence_3d")


def save_npz(path: str, **fields) -> str:
    """np.savez of the fields at `path`, creating its directory: the
    reference (u, v, p) triple through `io/npz.py::save_rollout`, as the
    JAX CLI writes it, the 3D u/v/w/p set as it is."""
    if list(fields) == ["u", "v", "p"]:
        return save_rollout(path, fields["u"], fields["v"], fields["p"])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **fields)
    return path


def cavity_bcs(dx, dy):
    u_bc = [dirichlet(0, "left"), dirichlet(1, "right"),
            dirichlet(0, "top"), dirichlet(0, "bottom")]
    v_bc = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    p_bc = [dirichlet(0, "top"), neumann(0, "bottom", dx, dy),
            neumann(0, "left", dx, dy), neumann(0, "right", dx, dy)]
    return u_bc, v_bc, p_bc


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("family", choices=_FAMILIES)
    p.add_argument("--nt", type=int, default=200)
    p.add_argument("--nit", type=int, default=None)
    p.add_argument("--nx", type=int, default=None)
    p.add_argument("--dt", type=float, default=0.001)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("--nu", type=float, default=None,
                   help="viscosity (default: 0.1 for the 2D families, "
                        "1/1600 for the 3D ones)")
    p.add_argument("--beta", type=float, default=1.25)
    p.add_argument("--method", default="semi_implicit",
                   choices=["semi_implicit", "explicit", "helmholtz"])
    p.add_argument("--corrected", action="store_true",
                   help="chorin_spectral: stable corrected-operator mode")
    p.add_argument("--pressure-mode", default="redblack",
                   choices=["redblack", "gauss_seidel", "multigrid", "cg",
                            "dst", "jacobi", "exact"],
                   help="pressure solver: chorin_fd takes "
                        "redblack|gauss_seidel|multigrid|cg|dst; direct_fd "
                        "takes jacobi|exact (exact = direct mixed-BC solve)")
    p.add_argument("--gemm-precision", default=None,
                   choices=["default", "high", "highest"],
                   help="chorin_fd: precision of the float32 ADI/dst/"
                        "helmholtz GEMMs; chorin_spectral: of every "
                        "per-step product (unset = highest): highest, "
                        "high (and unset) = fp32, default = bf16 inputs")
    p.add_argument("--transform", default="auto",
                   choices=["auto", "fft", "matmul"],
                   help="periodic families: auto picks the engine by the "
                        "card's measured rule (spectral_periodic / "
                        "spectral3d AUTO_FFT_CROSSOVER); fft/matmul force "
                        "an engine")
    p.add_argument("--precision", default="high",
                   choices=["default", "high", "highest"],
                   help="periodic matmul-DFT GEMMs: default = bf16 inputs, "
                        "high and highest = fp32")
    p.add_argument("--pallas-transform", default="auto",
                   choices=["auto", "on", "off"],
                   help="3D families: the fused transform kernels K6-K8 "
                        "(float32, matmul engine). auto: on for "
                        "--precision default at >= 128^3 cells where the "
                        "kernels fit shared memory; on/off force it")
    p.add_argument("--forcing", default="none",
                   choices=["none", "kolmogorov", "fno"],
                   help="periodic families: constant body forcing "
                        "(kolmogorov; fno, 2D only: the FNO benchmark's)")
    p.add_argument("--forcing-k", type=int, default=4,
                   help="forcing wavenumber (default 4)")
    p.add_argument("--forcing-amp", type=float, default=0.1,
                   help="forcing amplitude (default 0.1)")
    p.add_argument("--frame-stride", type=int, default=1,
                   help="periodic families: solver steps per SAVED frame "
                        "(--nt then counts saved frames)")
    p.add_argument("--spinup", type=int, default=0,
                   help="periodic families: solver steps discarded before "
                        "the first saved frame")
    p.add_argument("--compact", action="store_true",
                   help="2D periodic families: carry the compact "
                        "dealias-truncated spectrum (matmul engine)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-traj", type=int, default=1,
                   help="decaying_turbulence only: N trajectories of seeds "
                        "seed..seed+N-1 stacked as (N, nt, nx, ny)")
    p.add_argument("--pallas-momentum", action="store_true",
                   help="chorin_fd --method explicit: accepted for "
                        "command-line parity; on CUDA the port always runs "
                        "the explicit predictor as its K3 kernel")
    p.add_argument("--stream-dir", type=str, default=None,
                   help="stream frames to .npy files in this directory "
                        "instead of materializing the stacked rollout "
                        "(horizons larger than device memory): u/v/p for "
                        "the cavity families, u/v/p/w for the 2D periodic "
                        "ones")
    p.add_argument("--guard", action="store_true",
                   help="cavity families: run under the divergence guard "
                        "(utils/guard.py): on NaN/blow-up the state "
                        "freezes at the last good step and the first bad "
                        "step is reported")
    p.add_argument("--guard-max-abs", type=float, default=1e6,
                   help="guard trip threshold on any field magnitude")
    p.add_argument("--progress", action="store_true",
                   help="per-chunk progress bar (tqdm where it imports, "
                        "else a line a chunk) for long rollouts")
    p.add_argument("--chunk", type=int, default=25,
                   help="steps per chunk for --progress")
    p.add_argument("--dist", action="store_true",
                   help="periodic families: multi-process mode. Join the "
                        "process group from the NS_TPU_* environment (set "
                        "by `python -m ns_tpu_torch.launch`), shard the "
                        "rollout row-wise over every rank (one device a "
                        "rank), and write per-rank shard files (no rank "
                        "holds the full rollout). The coordinator "
                        "reassembles the standard npz at --out unless "
                        "--no-assemble")
    p.add_argument("--no-assemble", action="store_true",
                   help="--dist: skip the coordinator's npz reassembly "
                        "(leave only the per-rank shard files)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; a machine without a "
                        "card needs --device cpu)")
    p.add_argument("--out", type=str, default=None)
    return p


def build(argv=None):
    """Parse and check a command line as `main` does, and build its solver
    system (a 3D system computes its initial carry) without running the
    rollout. Returns (args, device, system)."""
    p = _parser()
    args = p.parse_args(argv)
    periodic_2d, periodic_3d = args.family in _2D, args.family in _3D
    if args.nu is None:
        args.nu = 6.25e-4 if periodic_3d else 0.1
    # the JAX CLI's flag rules, checked before any compute
    if args.pallas_momentum and args.family != "chorin_fd":
        p.error("--pallas-momentum applies to chorin_fd only")
    if args.forcing != "none" and not (periodic_2d or periodic_3d):
        p.error("--forcing applies to the periodic families only")
    if periodic_3d and args.forcing == "fno":
        p.error("the 3D family supports --forcing kolmogorov only")
    if periodic_3d and (args.dist or args.stream_dir or args.progress
                        or args.guard or args.n_traj > 1 or args.compact):
        p.error("--dist/--stream-dir/--progress/--guard/--n-traj/--compact "
                "are not supported for the 3D families")
    if args.frame_stride < 1:
        p.error(f"--frame-stride must be >= 1, got {args.frame_stride}")
    if args.spinup < 0:
        p.error(f"--spinup must be >= 0, got {args.spinup}")
    if args.frame_stride > 1 or args.spinup:
        if not (periodic_2d or periodic_3d):
            p.error("--frame-stride/--spinup apply to the periodic "
                    "families only")
        if args.dist or args.stream_dir or args.progress or args.guard:
            p.error("--frame-stride/--spinup are incompatible with "
                    "--dist/--stream-dir/--progress/--guard")
    if args.n_traj < 1:
        p.error(f"--n-traj must be >= 1, got {args.n_traj}")
    if args.n_traj > 1:
        if args.family != "decaying_turbulence":
            p.error("--n-traj needs random initial conditions "
                    "(decaying_turbulence)")
        if args.dist:
            p.error("--n-traj is not supported with --dist")
        if args.stream_dir or args.progress or args.guard:
            p.error("--n-traj is incompatible with "
                    "--stream-dir/--progress/--guard")
    if args.dist:
        if not periodic_2d:
            p.error("--dist currently supports the periodic families "
                    "(taylor_green|decaying_turbulence); the cavity "
                    "families' multi-process path is the sharded APIs in "
                    "ns_tpu_torch/parallel/ directly")
        if args.stream_dir:
            p.error("--stream-dir is not supported with --dist; shard "
                    "files go to <--out>.shards")
        if not ("NS_TPU_COORDINATOR" in os.environ
                or "MASTER_ADDR" in os.environ):
            p.error("--dist needs a process group: run under `python -m "
                    "ns_tpu_torch.launch --nprocs N [--platform cpu] -- "
                    "python -m ns_tpu_torch.cli.run_solver ... --dist`")
        return args, None, None
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    if periodic_3d:
        return args, device, _system_3d(args, device)
    if periodic_2d:
        return args, device, _system_2d(args, device)
    if args.family == "chorin_spectral":
        from ns_tpu_torch.solvers.chorin_spectral import NavierStokesSystem
        nx = args.nx or 51
        dx = dy = 2.0 / (nx - 1)
        u_bc, v_bc, _ = cavity_bcs(dx, dy)
        z = np.zeros((nx, nx))
        sys_ = NavierStokesSystem(z, z, z, u_bc, v_bc, nt=args.nt,
                                  nit=args.nit or 200, nx=nx, ny=nx,
                                  dt=args.dt, rho=args.rho, nu=args.nu,
                                  beta=args.beta, dtype=dtype,
                                  quirk_compat=not args.corrected,
                                  matmul_precision=(args.gemm_precision
                                                    or "highest"),
                                  device=device)
    elif args.family == "direct_fd":
        from ns_tpu_torch.solvers.direct_fd import NavierStokesSystem
        if args.pressure_mode not in ("jacobi", "exact", "redblack"):
            # 'redblack' is the flag default, i.e. "not specified"
            p.error("direct_fd supports --pressure-mode jacobi|exact, got "
                    f"{args.pressure_mode!r}")
        nx = args.nx or 50
        nit = args.nit or 50
        dx = dy = 2.0 / (nx - 1)
        u_bc, v_bc, p_bc = cavity_bcs(dx, dy)
        z = np.zeros((nx, nx))
        sys_ = NavierStokesSystem(z, z, z, u_bc, v_bc, p_bc, nt=args.nt,
                                  nit=nit, nx=nx, ny=nx, dt=args.dt,
                                  rho=args.rho, nu=args.nu, dtype=dtype,
                                  device=device,
                                  pressure_mode=("exact" if
                                                 args.pressure_mode == "exact"
                                                 else "jacobi"))
    else:
        from ns_tpu_torch.solvers.chorin_fd import NavierStokesSystem
        if args.pressure_mode in ("jacobi", "exact"):
            p.error("chorin_fd supports --pressure-mode redblack|gauss_"
                    f"seidel|multigrid|cg|dst, got {args.pressure_mode!r}")
        if args.pallas_momentum and args.method != "explicit":
            p.error("--pallas-momentum requires --method explicit")
        nx = args.nx or 51
        nit = args.nit or 200
        dx = dy = 2.0 / (nx - 1)
        u_bc, v_bc, p_bc = cavity_bcs(dx, dy)
        z = np.zeros((nx, nx))
        sys_ = NavierStokesSystem(z, z, z, u_bc, v_bc, p_bc, nt=args.nt,
                                  nit=nit, nx=nx, ny=nx, dt=args.dt,
                                  rho=args.rho, nu=args.nu, beta=args.beta,
                                  method=args.method, dtype=dtype,
                                  pressure_mode=args.pressure_mode,
                                  gemm_precision=args.gemm_precision,
                                  device=device)
    return args, device, sys_


def main(argv=None):
    """Run one rollout and write its npz. Returns a summary dict (output
    path, device, seconds and steps/s) for in-process callers."""
    t0 = time.perf_counter()
    args, device, sys_ = build(argv)
    if args.dist:
        return _run_distributed(args)
    setup = time.perf_counter() - t0
    if args.family in _3D:
        summary = _run_3d(args, device, sys_, t0)
    elif args.family in _2D:
        summary = _run_2d(args, device, sys_, t0)
    else:
        summary = _run_cavity_cli(args, device, sys_, t0)
    return {**summary, "setup_seconds": setup}


def _as_numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _run_cavity(sys_, args):
    """A cavity family's rollout, streamed to disk (--stream-dir), under
    the divergence guard (--guard) or in chunks with a progress bar
    (--progress), as the JAX CLI runs it. Returns (u, v, p), each (nt, nx,
    ny), or None when the frames were streamed."""
    if args.progress and args.guard and not args.stream_dir:
        print("note: --progress is ignored under --guard (the guarded "
              "rollout runs as one fused scan)")
    if args.stream_dir:
        if args.guard:
            print("note: --guard is ignored when streaming (the guard "
                  "needs the scan carry; stream chunks run unguarded)")
        from ns_tpu_torch.io.streaming import stream_rollout
        stream_rollout(sys_._step, sys_.state0, args.nt,
                       lambda s: {"u": s.u, "v": s.v, "p": s.p},
                       args.stream_dir)
        return None
    if args.progress and not args.guard:
        from ns_tpu_torch.utils.progress import chunked_simulate
        outs, _ = chunked_simulate(
            sys_._step, sys_.state0, args.nt,
            lambda s: {"u": s.u, "v": s.v, "p": s.p},
            chunk=args.chunk, desc=args.family)
        return outs["u"], outs["v"], outs["p"]
    if not args.guard:
        return sys_.simulate()
    from ns_tpu_torch.utils.guard import guarded_rollout
    final, states = guarded_rollout(sys_._step, sys_.state0, args.nt,
                                    max_abs=args.guard_max_abs)
    if bool(final.bad):  # the one read of the flag, after the rollout
        print(f"guard: divergence at step {int(final.first_bad_step)}"
              " — state frozen at the last good value")
    return states.u, states.v, states.p


def _run_cavity_cli(args, device: torch.device, sys_, t0: float) -> dict:
    """A cavity family's rollout and its u/v/p npz (or its streamed
    .npy files)."""
    fields = _run_cavity(sys_, args)
    if fields is None:
        return _streamed(args, device, t0, "streamed u/v/p")
    u, v, pr = (_as_numpy(a) for a in fields)
    elapsed = time.perf_counter() - t0
    out = args.out or (f"data_{args.method}.npz"
                       if args.family == "chorin_fd" else "data.npz")
    save_npz(out, u=u, v=v, p=pr)
    rate = args.nt / elapsed
    print(f"{args.family}: nt={args.nt} grid={u.shape[1]}x{u.shape[2]} on "
          f"{device} in {elapsed:.2f}s ({rate:.1f} steps/s) -> {out}")
    return {"out": out, "device": str(device), "seconds": elapsed,
            "steps_per_s": rate}


def _streamed(args, device: torch.device, t0: float, what: str) -> dict:
    """The summary of a --stream-dir run (the frames are on disk)."""
    elapsed = time.perf_counter() - t0
    rate = args.nt / elapsed
    print(f"{args.family}: nt={args.nt} {what} to "
          f"{args.stream_dir} on {device} in {elapsed:.2f}s ({rate:.1f} "
          "steps/s)")
    return {"out": args.stream_dir, "device": str(device),
            "seconds": elapsed, "steps_per_s": rate}


def _run_distributed(args) -> dict:
    """Multi-process periodic rollout: the rollout row-sharded over every
    rank, fed from each rank's rows of the initial field, written as
    per-rank shard files, and reassembled by the coordinator into the
    reference npz. The compact matmul engine writes u, v, p (and the
    npz); the others write the vorticity w.

    Launch (one host, N processes):
      python -m ns_tpu_torch.launch --nprocs 2 --platform cpu -- \\
          python -m ns_tpu_torch.cli.run_solver decaying_turbulence --dist \\
          --nx 256 --nt 100 --compact --transform matmul --device cpu
    The rank's platform is the launcher's (NS_TPU_PLATFORM), else
    --device's."""
    from ns_tpu_torch.parallel import distributed as dist
    from ns_tpu_torch.solvers import spectral_periodic as sp
    from ns_tpu_torch.utils.host import sync

    platform = os.environ.get("NS_TPU_PLATFORM") or torch.device(
        args.device).type
    device = dist.initialize(platform=platform)
    pid, nproc = dist.process_index(), dist.process_count()
    kw, w0 = _config_2d(args)
    cfg = sp.SpectralPeriodicConfig(**kw)
    nx = cfg.nx

    mesh = dist.make_global_mesh({"x": nproc})
    if cfg.transform == "matmul" and cfg.compact_spectrum:
        from ns_tpu_torch.parallel.spectral_sharded import (
            make_sharded_compact_simulate)
        sim, sharding = make_sharded_compact_simulate(cfg, mesh,
                                                      fields="uvp")
        names = ("u", "v", "p")
    else:
        from ns_tpu_torch.parallel.spectral_sharded import (
            make_sharded_simulate)
        sim, sharding = make_sharded_simulate(cfg, mesh)
        names = ("w",)

    lo, hi = dist.process_local_rows(cfg.nx, mesh, "x")
    w0_g = dist.global_array(sharding, w0[lo:hi])
    dist.barrier("rollout_start")  # the group's communicator is up
    t0 = time.perf_counter()
    out = sim(w0_g)
    if len(names) == 1:
        out = (out,)
    sync([a.local for a in out])
    elapsed = time.perf_counter() - t0

    out_dir = (args.out or f"{args.family}_dist.npz") + ".shards"
    for name, arr in zip(names, out):
        dist.save_array_shards(out_dir, name, arr)
    dist.barrier("rollout_io")
    rate = args.nt / elapsed
    print(f"p{pid}/{nproc}: {args.family} nt={args.nt} grid={nx}x{nx} on "
          f"{nproc} devices in {elapsed:.2f}s ({rate:.1f} steps/s) -> "
          f"{out_dir}", flush=True)

    path = None
    if dist.is_coordinator() and not args.no_assemble:
        fields = {n: dist.assemble_shards(out_dir, n) for n in names}
        path = args.out or f"{args.family}.npz"
        save_npz(path, **fields)
        print(f"p0: assembled {'/'.join(names)} -> {path}", flush=True)
    dist.barrier("done")
    dist.shutdown()
    return {"out": path, "shards": out_dir, "device": str(device),
            "seconds": elapsed, "steps_per_s": rate, "processes": nproc}


def _system_3d(args, device: torch.device):
    """The 3D periodic system (ns_tpu_torch.solvers.spectral3d) of a
    command line, with its initial carry on `device`."""
    from ns_tpu_torch.solvers import spectral3d as s3

    nx = args.nx or 64
    kw = dict(nt=args.nt, nx=nx, ny=nx, nz=nx, dt=args.dt, nu=args.nu,
              rho=args.rho, dtype=args.dtype, transform=args.transform,
              matmul_precision=args.precision, forcing=args.forcing,
              forcing_k=args.forcing_k, forcing_amp=args.forcing_amp,
              use_pallas_transform={"auto": "auto", "on": True,
                                    "off": False}[args.pallas_transform])
    cfg = s3.Spectral3DConfig(**kw)
    if args.family == "taylor_green_3d":
        u0 = s3.taylor_green_velocity(cfg)
    else:
        u0 = s3.random_solenoidal_velocity(cfg, seed=args.seed)
    return s3.NavierStokesSystem3D(u0, device=device, **kw)


def _config_2d(args):
    """(SpectralPeriodicConfig fields, initial vorticity as host numpy) of
    a 2D periodic command line: the plain run's and --dist's."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    nx = args.nx or 256
    kw = dict(nt=args.nt, nx=nx, ny=nx, dt=args.dt, nu=args.nu,
              rho=args.rho, dtype=args.dtype, transform=args.transform,
              matmul_precision=args.precision, compact_spectrum=args.compact,
              forcing=args.forcing, forcing_k=args.forcing_k,
              forcing_amp=args.forcing_amp)
    cfg = sp.SpectralPeriodicConfig(**kw)
    if args.family == "taylor_green":
        return kw, sp.taylor_green_vorticity(cfg)
    return kw, sp.decaying_turbulence_vorticity(cfg, seed=args.seed)


def _system_2d(args, device: torch.device):
    """The 2D periodic system (ns_tpu_torch.solvers.spectral_periodic) of
    a command line, with its initial carry on `device`."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    kw, w0 = _config_2d(args)
    return sp.NavierStokesSystem(w0, device=device, **kw)


def _run_2d(args, device: torch.device, sys_, t0: float) -> dict:
    """A 2D periodic rollout (or --n-traj rollouts through the one system)
    and its u/v/p npz."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    cfg, nx = sys_.cfg, sys_.cfg.nx
    strided = args.frame_stride > 1 or args.spinup > 0
    if args.guard:
        if args.progress or args.stream_dir:
            print("note: --guard is ignored for periodic "
                  "--stream-dir/--progress runs (unsupported for the "
                  "periodic families in general)")
        else:
            print("guard: not supported for the periodic families; "
                  "running unguarded")

    if args.stream_dir:
        from ns_tpu_torch.io.streaming import stream_rollout

        def extract(c):
            # the reference simulate() triple (u, v, p) plus vorticity, from
            # the carry's layout expanded to the rfft2 one
            u, v, p = sys_._extract(c[0])
            w = torch.fft.irfft2(sp._to_full(cfg, c[0]), s=(nx, nx))
            return {"u": u, "v": v, "p": p, "w": w}

        stream_rollout(lambda c: sys_._step(c)[0], sys_.carry0, args.nt,
                       extract, args.stream_dir)
        return _streamed(args, device, t0,
                         f"grid={nx}x{nx} streamed u/v/p/w")

    def rollout(w_ic=None):
        if args.progress:
            from ns_tpu_torch.utils.progress import chunked_simulate
            outs, _ = chunked_simulate(
                lambda c: sys_._step(c)[0], sys_.carry0, args.nt,
                lambda c: dict(zip("uvp", sys_._extract(c[0]))),
                chunk=args.chunk, desc=args.family)
            return outs["u"], outs["v"], outs["p"]
        if strided:
            return sys_.simulate_strided(args.nt, stride=args.frame_stride,
                                         spinup=args.spinup, w_ic=w_ic)
        return sys_.simulate() if w_ic is None else sys_.simulate_from(w_ic)

    if args.n_traj > 1:
        seeds = range(args.seed, args.seed + args.n_traj)
        trajs = [[_as_numpy(t) for t in rollout(
            sp.decaying_turbulence_vorticity(cfg, seed=s))] for s in seeds]
        u, v, pr = (np.stack(f) for f in zip(*trajs))
        out = args.out or f"{args.family}_x{args.n_traj}.npz"
    else:
        u, v, pr = (_as_numpy(t) for t in rollout())
        out = args.out or f"{args.family}.npz"
    elapsed = time.perf_counter() - t0
    save_npz(out, u=u, v=v, p=pr)
    steps = args.n_traj * (1 + args.spinup + (args.nt - 1) * args.frame_stride
                           if strided else args.nt)
    print(f"{args.family}: {args.n_traj} x nt={args.nt} (stride "
          f"{args.frame_stride}, spinup {args.spinup}) grid={nx}x{nx} on "
          f"{device} (transform {cfg.transform}, compact "
          f"{cfg.compact_spectrum}, precision {cfg.matmul_precision}) in "
          f"{elapsed:.2f}s ({steps / elapsed:.1f} steps/s) -> {out}")
    return {"out": out, "device": str(device), "seconds": elapsed,
            "steps_per_s": steps / elapsed, "transform": cfg.transform,
            "compact_spectrum": cfg.compact_spectrum}


def _run_3d(args, device: torch.device, sys_, t0: float) -> dict:
    """A 3D rollout and its u/v/w/p npz."""
    cfg, nx = sys_.cfg, sys_.cfg.nx
    strided = args.frame_stride > 1 or args.spinup > 0
    if strided:
        fields = sys_.simulate_strided(args.nt, stride=args.frame_stride,
                                       spinup=args.spinup)
        steps = 1 + args.spinup + (args.nt - 1) * args.frame_stride
    else:
        fields = sys_.simulate()
        steps = args.nt
    u3, v3, w3, p3 = (t.cpu().numpy() for t in fields)
    elapsed = time.perf_counter() - t0
    out = args.out or f"{args.family}.npz"
    save_npz(out, u=u3, v=v3, w=w3, p=p3)
    print(f"{args.family}: nt={args.nt} (stride {args.frame_stride}, "
          f"spinup {args.spinup}) grid={nx}^3 on {device} "
          f"(transform {cfg.transform}, fused "
          f"{cfg.use_pallas_transform}) in {elapsed:.2f}s "
          f"({args.nt / elapsed:.1f} frames/s) -> {out}")
    return {"out": out, "device": str(device), "seconds": elapsed,
            "steps_per_s": steps / elapsed,
            "frames_per_s": args.nt / elapsed,
            "use_pallas_transform": cfg.use_pallas_transform}


if __name__ == "__main__":
    main()
