"""Serve a trained surrogate checkpoint (or the solver oracle) over HTTP.

    python -m ns_tpu_torch.cli.serve --ckpt checkpoints/fno_w_10 [--port 8765]
    python -m ns_tpu_torch.cli.serve --solver --nx 128 --stride 100
    python -m ns_tpu_torch.cli.serve --ckpt DIR --device cpu

Port of `ns_tpu/cli/serve.py`, with the same flags and checks, plus
--device: a long-lived process loads the checkpoint (a JAX Trainer
checkpoint loads unchanged) or builds the solver, and answers any-horizon
extrapolation requests; see ns_tpu_torch/serve/server.py for the wire
protocol. It serves on the card unless given --device cpu (without a card
the command exits with an error). --warmup-steps runs one request before
the first client's: it builds the cuFFT and cuBLAS plans and the cached
tables (nothing is compiled).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt",
                     help="surrogate checkpoint.npz path or its directory")
    src.add_argument("--solver", action="store_true",
                     help="serve the classical periodic spectral solver "
                          "instead of a surrogate — the ORACLE behind the "
                          "same request contract, for on-demand ground "
                          "truth / A-B against a surrogate endpoint")
    p.add_argument("--dims", type=int, default=2, choices=[2, 3],
                   help="solver mode: 2 serves the periodic spectral "
                        "solver ((3, nx, nx) u/v/p frames); 3 serves the "
                        "3D family ((4, nx, nx, nx) u/v/w/p frames, nu "
                        "default 1/1600)")
    p.add_argument("--nx", type=int, default=64,
                   help="solver mode: grid size")
    p.add_argument("--dt", type=float, default=1e-3,
                   help="solver mode: time step")
    p.add_argument("--nu", type=float, default=None,
                   help="solver mode: viscosity (default 1e-3 for "
                        "--dims 2, 1/1600 for --dims 3)")
    p.add_argument("--stride", type=int, default=1,
                   help="solver mode: solver steps per served frame "
                        "(match a surrogate trained on strided frames)")
    p.add_argument("--forcing", default="none",
                   choices=["none", "kolmogorov", "fno"],
                   help="solver mode: body forcing (sustained turbulence)")
    p.add_argument("--forcing-k", type=int, default=4,
                   help="solver mode: forcing wavenumber")
    p.add_argument("--forcing-amp", type=float, default=0.1,
                   help="solver mode: forcing amplitude")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--chunk", type=int, default=64,
                   help="rollout chunk length: frames kept on the card "
                        "between host copies, looped to reach any horizon")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="run one request of this many rollout steps before "
                        "accepting requests (builds the cuFFT/cuBLAS plans "
                        "and cached tables at startup, not on the first "
                        "request)")
    p.add_argument("--coalesce", type=int, default=0,
                   help="> 0: coalesce up to N concurrent same-shape "
                        "single-state requests into one batched engine "
                        "call (surrogate engines only)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-request access logs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; a machine without a "
                        "card needs --device cpu)")
    args = p.parse_args(argv)
    if args.forcing != "none" and not args.solver:
        p.error("--forcing applies to --solver mode only (a surrogate's "
                "dynamics are whatever it was trained on)")
    if args.dims == 3:
        if not args.solver:
            p.error("--dims 3 applies to --solver mode (surrogate "
                    "checkpoints carry their own dimensionality)")
        if args.forcing == "fno":
            p.error("the 3D solver supports --forcing kolmogorov only")

    from ns_tpu_torch.core.device import resolve_device
    from ns_tpu_torch.serve.server import serve

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    if args.solver and args.dims == 3:
        from ns_tpu_torch.serve.solver import SolverEngine3D
        engine = SolverEngine3D(args.nx, args.nx, args.nx, dt=args.dt,
                                nu=(args.nu if args.nu is not None
                                    else 6.25e-4),
                                stride=args.stride, chunk=args.chunk,
                                forcing=args.forcing,
                                forcing_k=args.forcing_k,
                                forcing_amp=args.forcing_amp, device=device)
    elif args.solver:
        from ns_tpu_torch.serve.solver import SolverEngine
        engine = SolverEngine(args.nx, args.nx, dt=args.dt,
                              nu=(args.nu if args.nu is not None
                                  else 1e-3),
                              stride=args.stride, chunk=args.chunk,
                              forcing=args.forcing,
                              forcing_k=args.forcing_k,
                              forcing_amp=args.forcing_amp, device=device)
    else:
        from ns_tpu_torch.serve.engine import InferenceEngine
        engine = InferenceEngine.from_checkpoint(args.ckpt, chunk=args.chunk,
                                                 device=device)
    if args.warmup_steps:
        print(f"warmup: running a {args.warmup_steps}-step rollout ...",
              flush=True)
        engine.warmup(args.warmup_steps)
    serve(engine, host=args.host, port=args.port, quiet=args.quiet,
          coalesce=args.coalesce)


if __name__ == "__main__":
    main()
