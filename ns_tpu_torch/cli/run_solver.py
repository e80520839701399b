"""Run an FD cavity rollout with the torch port and save the reference-format
npz.

Port of `ns_tpu/cli/run_solver.py` for its two FD families, with the same
presets, flags and defaults:

  direct_fd  — nt=200 nit=50 50x50 lid-driven cavity
  chorin_fd  — nt=200 nit=200 51x51, semi_implicit (--method explicit for
               the other mode)

The npz goes through `ns_tpu.io.npz.save_rollout` (a numpy-only module,
reused rather than copied), so the trainer reads it unchanged. The other
families and the --guard/--progress/--stream-dir/--dist modes are not yet
ported and exit with an error that says so.

Examples:
  python -m ns_tpu_torch.cli.run_solver direct_fd --out data.npz
  python -m ns_tpu_torch.cli.run_solver chorin_fd --method explicit
  python -m ns_tpu_torch.cli.run_solver chorin_fd --device cpu --nt 5
"""

import argparse
import time

import numpy as np
import torch

from ns_tpu.io.npz import save_rollout
from ns_tpu_torch.core.bc import dirichlet, neumann

_FAMILIES = ["direct_fd", "chorin_fd", "chorin_spectral", "taylor_green",
             "decaying_turbulence", "taylor_green_3d",
             "decaying_turbulence_3d"]
_NOT_PORTED = "is not yet ported to ns_tpu_torch, see ROADMAP.md"


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
    p.add_argument("--nu", type=float, default=0.1)
    p.add_argument("--beta", type=float, default=1.25)
    p.add_argument("--method", default="semi_implicit",
                   choices=["semi_implicit", "explicit", "helmholtz"])
    p.add_argument("--pressure-mode", default="redblack",
                   choices=["redblack", "gauss_seidel", "multigrid", "cg",
                            "dst", "jacobi", "exact"],
                   help="chorin_fd: redblack|gauss_seidel|cg (multigrid and "
                        "dst not yet ported); direct_fd: jacobi (exact not "
                        "yet ported)")
    p.add_argument("--gemm-precision", default=None,
                   choices=["default", "high", "highest"],
                   help="chorin_fd float32 ADI matmuls: highest (and unset) "
                        "= fp32, high = TF32, default = bf16")
    p.add_argument("--pallas-momentum", action="store_true",
                   help="chorin_fd --method explicit: accepted for "
                        "command-line parity; on CUDA the port always runs "
                        "the explicit predictor as its K3 kernel")
    p.add_argument("--stream-dir", type=str, default=None,
                   help=f"{_NOT_PORTED} (exits with an error)")
    for flag in ("--guard", "--progress", "--dist"):
        p.add_argument(flag, action="store_true",
                       help=f"{_NOT_PORTED} (exits with an error)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda when available, else "
                        "cpu)")
    p.add_argument("--out", type=str, default=None)
    return p


def main(argv=None):
    """Run one rollout and write its npz. Returns a summary dict (output
    path, device, seconds and steps/s) for in-process callers."""
    p = _parser()
    args = p.parse_args(argv)
    if args.family not in ("direct_fd", "chorin_fd"):
        p.error(f"family {args.family!r} {_NOT_PORTED}")
    for flag in ("stream_dir", "guard", "progress", "dist"):
        if getattr(args, flag):
            p.error(f"--{flag.replace('_', '-')} {_NOT_PORTED}")
    if args.pallas_momentum and args.family != "chorin_fd":
        p.error("--pallas-momentum applies to chorin_fd only")
    device = torch.device(args.device or
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    dtype = torch.float64 if args.dtype == "float64" else torch.float32

    t0 = time.perf_counter()
    if args.family == "direct_fd":
        from ns_tpu_torch.solvers.direct_fd import NavierStokesSystem
        if args.pressure_mode not in ("jacobi", "exact", "redblack"):
            # 'redblack' is the flag default, i.e. "not specified"
            p.error("direct_fd supports --pressure-mode jacobi|exact, got "
                    f"{args.pressure_mode!r}")
        if args.pressure_mode == "exact":
            p.error(f"direct_fd --pressure-mode exact {_NOT_PORTED}")
        nx = args.nx or 50
        nit = args.nit or 50
        dx = dy = 2.0 / (nx - 1)
        u_bc, v_bc, p_bc = cavity_bcs(dx, dy)
        z = np.zeros((nx, nx))
        sys_ = NavierStokesSystem(z, z, z, u_bc, v_bc, p_bc, nt=args.nt,
                                  nit=nit, nx=nx, ny=nx, dt=args.dt,
                                  rho=args.rho, nu=args.nu, dtype=dtype,
                                  device=device)
        default_out = "data.npz"
    else:
        from ns_tpu_torch.solvers.chorin_fd import NavierStokesSystem
        if args.pressure_mode in ("jacobi", "exact"):
            p.error("chorin_fd supports --pressure-mode redblack|gauss_"
                    f"seidel|multigrid|cg|dst, got {args.pressure_mode!r}")
        if args.pressure_mode in ("multigrid", "dst"):
            p.error(f"chorin_fd --pressure-mode {args.pressure_mode} "
                    f"{_NOT_PORTED}")
        if args.method == "helmholtz":
            p.error(f"chorin_fd --method helmholtz {_NOT_PORTED}")
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
        default_out = f"data_{args.method}.npz"

    u, v, pr = (t.cpu().numpy() for t in sys_.simulate())
    elapsed = time.perf_counter() - t0
    out = args.out or default_out
    save_rollout(out, u, v, pr)
    rate = args.nt / elapsed
    print(f"{args.family}: nt={args.nt} grid={u.shape[1]}x{u.shape[2]} on "
          f"{device} in {elapsed:.2f}s ({rate:.1f} steps/s) -> {out}")
    return {"out": out, "device": str(device), "seconds": elapsed,
            "steps_per_s": rate}


if __name__ == "__main__":
    main()
