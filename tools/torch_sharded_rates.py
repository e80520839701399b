#!/usr/bin/env python3
"""The sharded compact periodic path (`parallel/spectral_sharded.py`) beside
the single-device engine on one card, warm and cold.

At 1024^2 decaying turbulence (run_solver's defaults: dt 1e-3, nu 0.1,
float32, compact matmul-DFT) and each precision ('default', 'high'), in
turns (single, sharded, sharded, single), steps/s of one warm call each:
  - the single-device engine: `NavierStokesSystem.final_state()` and
    `simulate()` (u, v, p a step by fp32 irfft2);
  - the sharded rollout and simulate(fields='uvp') on a mesh of one rank
    in a process group of one rank on NCCL (its all_to_all), then, after
    leaving it, with no process group (the collectives are the identity);
and first, in the fresh process, run_solver --dist's own call: the NCCL
simulate at 'default' over `cold_nt` steps, timed on its first call (cuBLAS
and module loading included, as in the CLI's rate) and on its second. Needs
a CUDA device. Prints the card's name and power limit, then one JSON line.

    python tools/torch_sharded_rates.py [n [nt [cold_nt]]]
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ns_tpu_torch.parallel import distributed as dist  # noqa: E402
from ns_tpu_torch.parallel import spectral_sharded as ss  # noqa: E402
from ns_tpu_torch.parallel.mesh import make_mesh, shard  # noqa: E402
from ns_tpu_torch.solvers import spectral_periodic as sp  # noqa: E402


def seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(n: int = 1024, nt: int = 20, cold_nt: int = 200) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("torch_sharded_rates needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    kw = dict(nt=nt, nx=n, ny=n, dt=0.001, nu=0.1, transform="matmul",
              compact_spectrum=True)
    out = {"card": smi, "n": n, "nt": nt}
    with tempfile.TemporaryDirectory() as tmp:
        dist.initialize("file://" + os.path.join(tmp, "init"), 1, 0, "cuda")
        dist.barrier()
        cfg = sp.SpectralPeriodicConfig(matmul_precision="default",
                                        **{**kw, "nt": cold_nt})
        sim, sharding = ss.make_sharded_compact_simulate(
            cfg, make_mesh({"x": 1}), fields="uvp")
        g = shard(sharding, sp.decaying_turbulence_vorticity(cfg, seed=0))
        out["cli_call"] = {"nt": cold_nt,
                           "first_steps_per_s": cold_nt / seconds(
                               lambda: sim(g)),
                           "second_steps_per_s": cold_nt / seconds(
                               lambda: sim(g))}
        del sim, g
        for nccl in (True, False):
            if not nccl:
                dist.shutdown()
            for prec in ("default", "high"):
                cfg = sp.SpectralPeriodicConfig(matmul_precision=prec, **kw)
                w0 = sp.decaying_turbulence_vorticity(cfg, seed=0)
                mesh = make_mesh({"x": 1})
                sim, sharding = ss.make_sharded_compact_simulate(
                    cfg, mesh, fields="uvp")
                roll, _ = ss.make_sharded_compact_rollout(cfg, mesh)
                g = shard(sharding, w0)
                res = {}
                single = sp.NavierStokesSystem(w0, **kw,
                                               matmul_precision=prec)
                fns = {"single_final": single.final_state,
                       "single_simulate": single.simulate,
                       "sharded_rollout": lambda: roll(g),
                       "sharded_simulate_uvp": lambda: sim(g)}
                for f in fns.values():  # warm-up
                    f()
                runs = {k: [] for k in fns}
                for order in (list(fns), list(fns)[::-1]):
                    for k in order:
                        runs[k].append(nt / seconds(fns[k]))
                res.update({k: statistics.mean(v) for k, v in runs.items()})
                out[("nccl_" if nccl else "no_group_") + prec] = res
    return out


if __name__ == "__main__":
    print(json.dumps(main(*map(int, sys.argv[1:]))))
