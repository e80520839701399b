#!/usr/bin/env python3
"""Time chorin_spectral's three corrected-mode engines on the card.

The engines: dense (full-size eigen transforms), and the parity split
(`ops/parity.py`) with its two eigen-solve schedules, 'composed' and
'quadrant'. The JAX package turns the parity split on from an interior of
`_PARITY_MIN_INTERIOR` = 192 and takes 'composed' by default, both
measured on a TPU v5e; this is the card's reading of the same choice.

For each grid (default 256, 512, 1024) and precision ('highest',
'default'): the corrected lid cavity (float32, dt 1e-6, nu 0.1) from a
state that has taken 5 steps, its cached step loop of `--steps` steps
timed `--reps` times with the engines in turns (dense, composed, quadrant,
then the reverse), each timing ending in a synchronize. Prints one JSON
line: per engine and precision the median steps/s, the min and max, the
set-up seconds (host eigendecompositions and the copy to the card), and
the card's name and power limit.

    python tools/torch_chebyshev_engines.py [n ...] [--steps 20] [--reps 6]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ns_tpu_torch.cli.run_solver import cavity_bcs  # noqa: E402
from ns_tpu_torch.solvers import chorin_spectral as cs  # noqa: E402

ENGINES = {"dense": dict(parity_split=False),
           "composed": dict(parity_split=True, parity_eig_form="composed"),
           "quadrant": dict(parity_split=True, parity_eig_form="quadrant")}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def engine_loop(n: int, prec: str, engine: str, steps: int):
    """(set-up seconds, a function that runs `steps` cached steps)."""
    u_bc, v_bc, _ = cavity_bcs(2.0 / (n - 1), 2.0 / (n - 1))
    cfg = cs.ChorinSpectralConfig(nt=steps, nx=n, ny=n, dt=1e-6, nu=0.1,
                                  quirk_compat=False,
                                  deflate_pressure_nullspace=True,
                                  matmul_precision=prec, **ENGINES[engine])
    t0 = time.perf_counter()
    step = cs.make_step(cfg, u_bc, v_bc, dtype=torch.float32, device="cuda")
    z = np.zeros((n, n))
    state = cs.init_state(cfg, z, z, z, u_bc, v_bc, dtype=torch.float32,
                          device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    for _ in range(5):
        state = step(state)
    cache0 = step.seed(state)

    def run():
        s, c = state, cache0
        for _ in range(steps):
            s, c = step.cached(s, c)
        return s

    return setup, run


def timed(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(out.u).all()):
        raise SystemExit("non-finite state")
    return dt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sizes", nargs="*", type=int, default=[256, 512, 1024])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--reps", type=int, default=6)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    result = {"card": card(), "steps": args.steps, "reps": args.reps,
              "rows": []}
    for n in args.sizes:
        for prec in ("highest", "default"):
            loops = {}
            for engine in ENGINES:
                loops[engine] = engine_loop(n, prec, engine, args.steps)
                timed(loops[engine][1])  # warm-up
            rates = {e: [] for e in ENGINES}
            order = list(ENGINES)
            for r in range(args.reps):
                for e in (order if r % 2 == 0 else order[::-1]):
                    rates[e].append(args.steps / timed(loops[e][1]))
            for e in ENGINES:
                row = {"n": n, "precision": prec, "engine": e,
                       "setup_s": loops[e][0],
                       "steps_per_s_median": statistics.median(rates[e]),
                       "steps_per_s_min": min(rates[e]),
                       "steps_per_s_max": max(rates[e])}
                result["rows"].append(row)
                print(f"{n}^2 {prec:8s} {e:9s} "
                      f"{row['steps_per_s_median']:9.1f} steps/s "
                      f"({row['steps_per_s_min']:.1f}-"
                      f"{row['steps_per_s_max']:.1f}), set-up "
                      f"{row['setup_s']:.2f} s", file=sys.stderr, flush=True)
            del loops
            torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
