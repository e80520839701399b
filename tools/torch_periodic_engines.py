#!/usr/bin/env python3
"""The 2D periodic step loop on each engine, side by side on the card: the
reading that sets `spectral_periodic.SpectralPeriodicConfig`'s 'auto' rule.

For each grid n^2 (default 256, 1024, 2048, 4096): decaying turbulence at
bench.py's physics (dt 5e-4, nu 1e-4, float32) on the fft engine (cuFFT)
and on the compact matmul-DFT engine, complex and real_gemm, each at
'default' (bf16 inputs) and 'high' (fp32), timed by
`ns_tpu_torch.cli.profile_run` (the median steps/s of 3 timed
`final_state()` rollouts after a warm-up, the device idle share and the
top kernels of a profiled one). The engines run in turns, in one order and
then in the reverse order. fft and the compact engines go through
run_solver's command line; real_gemm (no CLI flag, as in the JAX CLI)
through `NavierStokesSystem(real_gemm=True)`. Needs a CUDA device. Prints
the card's name and power limit, then one JSON line.

    python tools/torch_periodic_engines.py [n ...]
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ns_tpu_torch.cli import profile_run, run_solver  # noqa: E402
from ns_tpu_torch.solvers import spectral_periodic as sp  # noqa: E402

STEPS = {256: 200, 1024: 100, 2048: 40, 4096: 10}  # nt of a timed rollout
ENGINES = [("fft", None), ("compact", "default"), ("real_gemm", "default"),
           ("compact", "high"), ("real_gemm", "high")]


def argv(n: int, engine: str, prec) -> list:
    a = ["decaying_turbulence", "--nx", str(n), "--nt", str(STEPS.get(n, 20)),
         "--dt", "5e-4", "--nu", "1e-4", "--device", "cuda"]
    if engine == "fft":
        return a + ["--transform", "fft"]
    return a + ["--transform", "matmul", "--compact", "--precision", prec]


def measure(n: int, engine: str, prec) -> dict:
    args, _, sys_ = run_solver.build(argv(n, "compact" if engine ==
                                          "real_gemm" else engine, prec))
    if engine == "real_gemm":
        cfg = sys_.cfg
        sys_ = sp.NavierStokesSystem(
            sp.decaying_turbulence_vorticity(cfg, seed=0), nt=cfg.nt,
            nx=n, ny=n, dt=cfg.dt, nu=cfg.nu, transform="matmul",
            matmul_precision=prec, real_gemm=True, device="cuda")
    r = profile_run.profile_rollout(sys_.final_state, args.nt)
    del sys_
    torch.cuda.empty_cache()
    return r


def main(sizes):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "device": torch.cuda.get_device_name(0),
           "grids": {}}
    for n in sizes:
        row = {}
        for engine, prec in ENGINES + ENGINES[::-1]:
            key = engine if prec is None else f"{engine} {prec}"
            r = measure(n, engine, prec)
            cell = row.setdefault(key, {"steps_per_s": [], "idle_share": [],
                                        "busy_ms_per_step": []})
            cell["steps_per_s"].append(r["steps_per_s_median_of_3"])
            cell["idle_share"].append(r["device_idle_share"])
            cell["busy_ms_per_step"].append(r["device_busy_ms"]
                                            / STEPS.get(n, 20))
            cell["top_device_ms"] = r["top_device_ms"][:4]
            print(f"{n}^2 {key:18s} {r['steps_per_s_median_of_3']:9.1f} "
                  f"steps/s, idle {r['device_idle_share']:.3f}", flush=True)
        out["grids"][str(n)] = row
    print(json.dumps(out))


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [256, 1024, 2048, 4096])
