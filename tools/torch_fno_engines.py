"""FNO spectral engines on the card: fft against matmul-DFT rollouts.

The port's counterpart of tools/bench_fno_transform.py: an fno_w-shaped
FNO2D (one channel, the full dealiased band, modes n//3 + 1) rolled out
with the per-step dealias filter on the same engine, on an NVIDIA GPU, at
each grid size, the two engines from the same parameters timed in turns
(fft, matmul, matmul, fft; each turn one synchronised rollout after a
warm-up). It informs `models/fno.py::_MATMUL_MAX_SIDE` (the 'auto'
crossover, the TPU's 512). Prints one JSON line: ms a step of each turn,
the engines' largest difference over the rollout (relative to its max),
and the card's name and power limit. Needs a CUDA device.

    python tools/torch_fno_engines.py [--sizes 64 128 256 512] [--width 32]
        [--steps 64] [--batch 1]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from ns_tpu_torch.models.fno import FNO2D  # noqa: E402
from ns_tpu_torch.models.vorticity import dealias_field  # noqa: E402


def rollout_ms(model, x0, steps: int, engine: str) -> float:
    post = lambda x: dealias_field(x, engine=engine)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        model.rollout(x0, steps, post=post)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[64, 128, 256, 512])
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fno_engines needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    rows = []
    for n in args.sizes:
        modes = n // 3 + 1
        gen = torch.Generator(device="cuda").manual_seed(0)
        models = {t: FNO2D(n, n, width=args.width, modes=modes, channels=1,
                           transform=t, device="cuda", generator=gen)
                  for t in ("fft", "matmul")}
        models["matmul"].load_state_dict(models["fft"].state_dict())
        x0 = torch.randn(args.batch, 1, n, n, device="cuda", generator=gen)
        with torch.inference_mode():
            a, b = (models[t].rollout(
                x0, 8, post=lambda x, t=t: dealias_field(x, engine=t))
                for t in ("fft", "matmul"))
        diff = float((a - b).abs().max() / b.abs().max())
        ms = {"fft": [], "matmul": []}
        for t in ("fft", "matmul"):  # warm-up: plans, tables
            rollout_ms(models[t], x0, 4, t)
        for t in ("fft", "matmul", "matmul", "fft"):
            ms[t].append(rollout_ms(models[t], x0, args.steps, t))
        rows.append({"n": n, "modes": modes, "ms_per_step": ms,
                     "fft_vs_matmul_8_steps": diff})
        print(f"{n}^2 modes {modes}: fft {ms['fft']} ms/step, matmul "
              f"{ms['matmul']} ms/step", file=sys.stderr, flush=True)
        del models
        torch.cuda.empty_cache()
    print(json.dumps({"tool": "torch_fno_engines", "card": smi.stdout.strip(),
                      "device": torch.cuda.get_device_name(0),
                      "width": args.width, "batch": args.batch,
                      "steps": args.steps, "float32": True,
                      "precision": None, "rows": rows}))


if __name__ == "__main__":
    main()
