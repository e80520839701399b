#!/usr/bin/env python3
"""Time the FD kernels on the card, beside their plain twins and bounds,
at the main path's shapes: K1 (`sor_redblack_fused`) at 51^2 and at
170^2, the largest grid one block holds in float32; K2 (`jacobi_fused`)
at 50^2, nit=50, with the cavity p BCs; K2's multi-block form
(`jacobi_multiblock`) at 1024^2, nit=50, in float32 and float64; K3
(`momentum_explicit_fused`) at 51^2 and 1024^2 with the cavity u/v BCs;
K4 (`sor_redblack_packed_multiblock`) at 1024^2 and K5
(`sor_redblack_multiblock`) at 1025^2, each in float32 and float64, beside
K5's colour-group kernels on the same input (and whether the results are
bitwise equal). Every SOR solve is nit=200, tol=5e-6, as chorin_fd runs it.
K2mb and K3 also get the profiler's device time a call and the CUDA
records a call, K3 its wrapper's host time a call (calls back to back with
no sync, on the host's clock), and both their times on a field at rest
(`_lid`: zero but for the 64 rows next to the lid, as a cavity's early
steps hold it; a zero dividend takes the IEEE division's slow path). Needs a CUDA device. Prints the card's
name and power limit, the registers and spills ptxas reported for the SOR,
Jacobi and momentum kernels, and one JSON line of times.

It uses only the wrappers' public entry points (and the colour-group route
where the tree has it as `_color_groups`; before that, K5's wrapper was
that route), so a copy of it runs in another checkout of the repo too: to
compare two versions of the kernels in one call, run it in each tree in
turns (old, new, new, old).

    python tools/torch_time_fd_kernels.py [--label NAME]
"""

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each SOR kernel instance in nvcc's log."""
    out, name = {}, None
    for line in open(log):
        m = re.search(r"Compiling entry function '_ZN2ns\d+(\w+?)I(\w+?)E", line)
        if m:
            name = m.group(1) + "<" + m.group(2) + ">"
            name = name if any(k in name for k in ("sor", "jacobi",
                                                   "momentum")) else None
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            out.setdefault(name, {})["spill_stores"] = int(spill.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.setdefault(name, {})["registers"] = int(regs.group(1))
            name = None
    return out


def profiled(fn, reps: int) -> tuple:
    """(device ms a call, CUDA records a call) by the profiler over `reps`
    calls: the summed duration of the kernel and memset records."""
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
    us = sum(e.time_range.elapsed_us() for e in recs)
    return us / reps / 1e3, len(recs) / reps


def host_ms(fn, reps: int) -> float:
    """The host's time a call of a wrapper, calls back to back, no sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    from ns_tpu_torch.core.bc import apply_bcs, dirichlet, neumann
    from ns_tpu_torch.ops import kernels, poisson
    from ns_tpu_torch.ops.kernels import _build
    from ns_tpu_torch.ops.kernels import poisson_kernels as pk

    groups = getattr(pk, "_color_groups", None)
    if groups is None:
        def groups(p, c, dx, dy, beta, tol, max_iter, k):
            return kernels.sor_redblack_multiblock(p, c, dx, dy, beta, tol,
                                                   max_iter, k)

    lib = _build.build_library()
    regs = ptxas_report(str(lib.with_suffix(".log")))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)

    def rand(n, dtype, scale=1.0):
        return (scale * torch.randn((n, n), generator=gen,
                                    dtype=torch.float64)).to(dev, dtype)

    def at_rest(x):
        """x but for the 64 rows next to the lid (row nx - 1), zeroed."""
        x = x.clone()
        x[:-64] = 0
        return x

    rows = {}
    for n in (51, 170):
        h = 2.0 / (n - 1)
        p, c = rand(n, torch.float32), rand(n, torch.float32, h * h)
        sweeps = chip_smoke.sor_sweeps(p[None], c[None], h, 1.25, 5e-6,
                                       200)[0]
        ms, plain = chip_smoke.paired_ms(
            lambda: kernels.sor_redblack_fused(p, c, h, h, 1.25, 5e-6, 200),
            lambda: poisson.sor_redblack(p, c, h, h, 1.25, 5e-6, 200), 20, 2)
        b = chip_smoke.bound(3 * n * n * 4, 10 * (n - 2) ** 2 * sweeps,
                             chip_smoke.FP32_FLOPS)
        rows[f"K1 {n}x{n} float32"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1],
            "sweeps": sweeps, "us_per_sweep": 1e3 * ms / sweeps}
    n = 50
    h = 2.0 / (n - 1)
    bcs = [dirichlet(0, "top"), neumann(0, "bottom", h, h),
           neumann(0, "left", h, h), neumann(0, "right", h, h)]
    p, b = rand(n, torch.float32), rand(n, torch.float32, 10.0)
    ms, plain = chip_smoke.paired_ms(
        lambda: kernels.jacobi_fused(p, b, h, h, 50, bcs),
        lambda: poisson.jacobi(p, b, h, h, 50,
                               bc_fn=lambda q: apply_bcs(q, bcs)), 200, 10)
    bd = chip_smoke.bound(3 * n * n * 4, 8 * (n - 2) ** 2 * 50,
                          chip_smoke.FP32_FLOPS)
    rows[f"K2 {n}x{n} float32"] = {
        "ms": ms, "plain_ms": plain, "bound_ms": bd[0], "bound_by": bd[1],
        "sweeps": 50, "us_per_sweep": 1e3 * ms / 50}
    n = 1024
    h = 2.0 / (n - 1)
    bcs = [dirichlet(0, "top"), neumann(0, "bottom", h, h),
           neumann(0, "left", h, h), neumann(0, "right", h, h)]
    for dtype in (torch.float32, torch.float64):
        p, b = rand(n, dtype), rand(n, dtype, 10.0)
        ker = lambda: kernels.jacobi_multiblock(p, b, h, h, 50, bcs)
        twin = lambda: poisson.jacobi(p, b, h, h, 50,
                                      bc_fn=lambda q: apply_bcs(q, bcs))
        ms, plain = chip_smoke.paired_ms(ker, twin, 20, 2)
        dms, recs = profiled(ker, 10)
        item = torch.empty((), dtype=dtype).element_size()
        peak = chip_smoke.FP32_FLOPS if dtype == torch.float32 else 34e12
        bd = chip_smoke.bound(3 * n * n * item, 8 * (n - 2) ** 2 * 50, peak)
        rows[f"K2mb {n}x{n} {str(dtype)[6:]}"] = {
            "ms": ms, "device_ms": dms, "cuda_records_per_call": recs,
            "plain_ms": plain, "bound_ms": bd[0], "bound_by": bd[1],
            "sweeps": 50, "us_per_sweep": 1e3 * ms / 50}
        p, b = at_rest(p), at_rest(b)
        rows[f"K2mb {n}x{n} {str(dtype)[6:]}"].update(
            ms_lid=chip_smoke.time_ms(ker, 20),
            device_ms_lid=profiled(ker, 10)[0])
    cav_u = [dirichlet(0, "left"), dirichlet(1, "right"), dirichlet(0, "top"),
             dirichlet(0, "bottom")]
    cav_v = [dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    for n in (51, 1024):
        h = 2.0 / (n - 1)
        f = [rand(n, torch.float32) for _ in range(4)]
        margs = (*f, 1e-5, h, h, 0.01, cav_u, cav_v, True)
        ker = lambda: kernels.momentum_explicit_fused(*margs)
        twin = lambda: kernels.momentum_explicit(*margs)
        ms, plain = chip_smoke.paired_ms(ker, twin, 200, 20)
        dms, recs = profiled(ker, 50)
        bd = chip_smoke.bound(6 * n * n * 4, 80 * (n - 2) ** 2,
                              chip_smoke.FP32_FLOPS)
        rows[f"K3 {n}x{n} float32"] = {
            "ms": ms, "device_ms": dms, "cuda_records_per_call": recs,
            "host_ms": host_ms(ker, 500), "plain_ms": plain,
            "bound_ms": bd[0], "bound_by": bd[1]}
        margs = (*[at_rest(x) for x in f], *margs[4:])
        rows[f"K3 {n}x{n} float32"].update(
            ms_lid=chip_smoke.time_ms(ker, 200),
            device_ms_lid=profiled(ker, 50)[0])
    for tag, n, wrapper, twin_fn in (
            ("K4", 1024, kernels.sor_redblack_packed_multiblock,
             kernels.sor_redblack_packed_tiled),
            ("K5", 1025, kernels.sor_redblack_multiblock,
             kernels.sor_redblack_tiled)):
        h = 2.0 / (n - 1)
        for dtype in (torch.float32, torch.float64):
            p, c = rand(n, dtype), rand(n, dtype, h * h)
            ker = lambda: wrapper(p, c, h, h, 1.25, 5e-6, 200)
            grp = lambda: groups(p, c, h, h, 1.25, 5e-6, 200, 8)
            # the gate's sweeps on this data: the colour groups launch
            # once a group of 8 (in either tree)
            n0 = kernels.sor_redblack_multiblock.launches
            grp()
            sweeps = 8 * (kernels.sor_redblack_multiblock.launches - n0)
            twin = lambda: twin_fn(p, c, h, h, 1.25, 5e-6, 200)
            same = bool(torch.equal(ker(), grp()))
            ms, ms_g, plain = chip_smoke.turns_ms([ker, grp, twin], 3)
            item = torch.empty((), dtype=dtype).element_size()
            peak = chip_smoke.FP32_FLOPS if dtype == torch.float32 else 34e12
            bd = chip_smoke.bound(3 * n * n * item,
                                  10 * (n - 2) ** 2 * sweeps, peak)
            rows[f"{tag} {n}x{n} {str(dtype)[6:]}"] = {
                "ms": ms, "plain_ms": plain, "color_groups_ms": ms_g,
                "bitwise_equal_to_color_groups": same, "bound_ms": bd[0],
                "bound_by": bd[1], "sweeps": sweeps,
                "us_per_group": 1e3 * ms / (sweeps // 8)}
    print(json.dumps({"label": args.label, "card": card, "ptxas": regs,
                      "times": rows}))


if __name__ == "__main__":
    main()
