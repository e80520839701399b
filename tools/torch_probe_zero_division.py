#!/usr/bin/env python3
"""Time K2mb, K3 and K2 on random, all-zero and at-rest inputs, to show
what a zero dividend costs the IEEE divisions of their cell updates.

A cavity's early steps hold most cells at exactly zero; a division whose
dividend is zero takes the division's slow path on the card. This script
times, float32, CUDA events (ms a call, calls back to back) and the
profiler's device time a call (`device_ms`, the CUDA records' summed
duration):
  K2mb (`jacobi_multiblock`) at 1024^2, nit=50, cavity p BCs;
  K3 (`momentum_explicit_fused`) at 1024^2, cavity u/v BCs, quirk on (and
  quirk off, device time only);
  K2 (`jacobi_fused`) at 50^2, nit=50;
on random fields, all-zero fields and fields at rest (zero but for the 64
rows next to the lid), and K3 at 51^2 with its wrapper's host time a call.
It uses only public wrappers and `chip_smoke.time_ms`, so a copy runs in
another checkout too: run it from each tree's root in turns (a, b, b, a)
in one call to compare two versions of the kernels.

    python tools/torch_probe_zero_division.py     # one JSON line

Needs a CUDA device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ns_tpu_torch.core.bc import dirichlet, neumann  # noqa: E402
from ns_tpu_torch.ops import kernels  # noqa: E402


def profiled(fn, reps: int) -> float:
    """Device ms a call: the summed duration of the CUDA records."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    recs = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in recs) / reps / 1e3


def host_ms(fn, reps: int) -> float:
    """The host's time a call, calls back to back with no sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)

    def field(n, kind, scale=1.0):
        if kind == "zeros":
            return torch.zeros((n, n), device=dev)
        x = (scale * torch.randn((n, n), generator=gen,
                                 dtype=torch.float64)).to(dev, torch.float32)
        if kind == "at rest":  # zero but for the 64 rows next to the lid
            x[:-64] = 0
        return x

    def cavity(h):
        p_bc = [dirichlet(0, "top"), neumann(0, "bottom", h, h),
                neumann(0, "left", h, h), neumann(0, "right", h, h)]
        u_bc = [dirichlet(0, "left"), dirichlet(1, "right"),
                dirichlet(0, "top"), dirichlet(0, "bottom")]
        v_bc = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
        return p_bc, u_bc, v_bc

    out = {}
    n = 1024
    h = 2.0 / (n - 1)
    p_bc, u_bc, v_bc = cavity(h)
    for kind in ("random", "zeros", "at rest"):
        p, b = field(n, kind), field(n, kind, 10.0)
        k2mb = lambda: kernels.jacobi_multiblock(p, b, h, h, 50, p_bc)
        out[f"K2mb 1024^2 {kind}"] = {"ms": chip_smoke.time_ms(k2mb, 20),
                                      "device_ms": profiled(k2mb, 10)}
        f = [field(n, kind) for _ in range(4)]
        for quirk in (True, False):
            k3 = lambda: kernels.momentum_explicit_fused(
                *f, 1e-5, h, h, 0.01, u_bc, v_bc, quirk)
            row = {"device_ms": profiled(k3, 50)}
            if quirk:
                row["ms"] = chip_smoke.time_ms(k3, 100)
            out[f"K3 1024^2 {kind} quirk={quirk}"] = row
    n = 50
    h = 2.0 / (n - 1)
    p_bc, _, _ = cavity(h)
    for kind in ("random", "zeros"):
        p, b = field(n, kind), field(n, kind, 10.0)
        k2 = lambda: kernels.jacobi_fused(p, b, h, h, 50, p_bc)
        out[f"K2 50^2 {kind}"] = {"ms": chip_smoke.time_ms(k2, 200),
                                  "device_ms": profiled(k2, 50)}
    n = 51
    h = 2.0 / (n - 1)
    _, u_bc, v_bc = cavity(h)
    f = [field(n, "random") for _ in range(4)]
    k3 = lambda: kernels.momentum_explicit_fused(*f, 1e-5, h, h, 0.01, u_bc,
                                                 v_bc, True)
    out["K3 51^2 random"] = {"ms": chip_smoke.time_ms(k3, 200),
                             "device_ms": profiled(k3, 50),
                             "host_ms": host_ms(k3, 1000)}
    print(json.dumps({"tree": os.path.basename(os.getcwd()),
                      "card": chip_smoke.phase_device(), "times": out}))


if __name__ == "__main__":
    main()
