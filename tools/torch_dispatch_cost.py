#!/usr/bin/env python3
"""What a kernel call costs the host on the card, and the host-bound step
loop it sits in: K1 (`sor_redblack_fused`, nit 200, tol 5e-6) and K3
(`momentum_explicit_fused`, the cavity u/v BCs) at 51^2 float32, each
wrapper called back to back with no sync, on the host's clock (the median
and the least of nine windows of 500 calls, after a warm-up), and the
eager chorin_fd explicit 51^2 step loop (`cli/profile_run`: steps/s,
median of 3, nt 1000, the CLI's defaults otherwise). Needs a CUDA
device; prints the card's name and power limit and one JSON line.

It uses only the wrappers' public entry points and `cli/profile_run`, so
a copy of it runs in another checkout too: to compare two versions of the
call path in one machine, run it in each tree in turns (old, new, new,
old).

    python tools/torch_dispatch_cost.py [--label NAME]
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

CALLS, WINDOWS = 500, 9


def host_us(fn) -> list:
    """Host microseconds a call over each window of CALLS calls back to
    back (no sync inside a window; the device drains between windows)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / CALLS)
        torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    from ns_tpu_torch.cli import profile_run
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.ops import kernels

    n = 51
    h = 2.0 / (n - 1)
    gen = torch.Generator().manual_seed(1234)
    f = [torch.randn((n, n), generator=gen).cuda() for _ in range(4)]
    u_bc, v_bc, _ = cavity_bcs(h, h)
    c = f[1] * h * h
    calls = {
        "K1 51x51 float32": lambda: kernels.sor_redblack_fused(
            f[0], c, h, h, 1.25, 5e-6, 200),
        "K3 51x51 float32": lambda: kernels.momentum_explicit_fused(
            *f, 1e-3, h, h, 0.1, u_bc, v_bc, True),
    }
    rows = {}
    for name, fn in calls.items():
        runs = host_us(fn)
        rows[name] = {"host_us_per_call": statistics.median(runs),
                      "least_us_per_call": min(runs), "windows": runs}
    loop = profile_run.profile(["chorin_fd", "--method", "explicit",
                                "--nt", "1000"])
    rows["chorin_fd explicit 51x51 step loop"] = {
        k: loop[k] for k in ("steps_per_s_median_of_3", "steps_per_s",
                             "device_idle_share", "device_records_per_step")}
    print(json.dumps({"label": args.label, "card": card, "rows": rows}))


if __name__ == "__main__":
    main()
