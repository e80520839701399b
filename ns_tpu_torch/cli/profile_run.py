"""Profile the step loop of one port rollout on the card: steps/s, device
idle share and device time by kernel.

Takes run_solver's command line (same families, flags and defaults) and
times the rollout without the frame extraction, readback and npz write
of the CLI: `simulate()` for the cavity families (FD and Chebyshev),
`final_state()` for the periodic ones (2D and 3D). The set-up (building
the system: host tables, eigendecompositions, the copy to the card) is
timed apart, as `setup_s`. One warm-up rollout, then the median steps/s
of three timed ones, then one rollout under `torch.profiler` (CPU and
CUDA activity) inside a CPU range of its own, whose idle share is 1 - the
union of the device records (kernels, copies, memsets) that start inside
that range over the range's length (`utils/profiling.py::device_window`):
records that overlap count once, and the profiler's own start lies
outside. Needs a CUDA device: there is no CPU mode for device metrics.

    python -m ns_tpu_torch.cli.profile_run taylor_green_3d --nx 256 --nt 8 \\
        --transform matmul --precision default
    python -m ns_tpu_torch.cli.profile_run direct_fd --nx 1024 --nt 20 \\
        --dt 1e-5 --nu 0.01
    python -m ns_tpu_torch.cli.profile_run decaying_turbulence --nx 1024 \\
        --nt 200 --dt 5e-4 --nu 1e-4 --transform matmul --compact \\
        --precision default
    python -m ns_tpu_torch.cli.profile_run chorin_spectral --corrected \\
        --nx 1024 --nt 20 --dt 1e-6

Prints one JSON line, with the device records (kernels, copies, memsets)
a step, the top kernels by device time, the top host ops by their own CPU
time and, where an SOR wrapper (K1, K4, K5) solved, its sweeps a solve in
the profiled rollout (`ops.kernels.sweep_counts`).
"""

import collections
import json
import statistics
import sys
import time

import torch

from ns_tpu_torch.cli import run_solver
from ns_tpu_torch.ops import kernels
from ns_tpu_torch.utils import profiling

RANGE = "profile_run.rollout"


def device_summary(events: list, nt: int) -> dict:
    """The profiled rollout's device share from its Chrome trace: the
    range `RANGE`'s length, the union of its device records, the idle
    share, the records a step, the top records by device time and the
    device-to-host copies' time."""
    win = profiling.device_window(events, RANGE)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, _, dur in win["records"]:
        by_name[name][0] += dur
        by_name[name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    span_us = win["t1"] - win["t0"]
    return {
        "profiled_range_ms": span_us / 1e3,
        "device_busy_ms": win["busy_us"] / 1e3,
        "device_idle_share": 1.0 - win["busy_us"] / span_us,
        "device_records_per_step": len(win["records"]) / nt,
        "top_device_ms": [[name[:80], t / 1e3, n] for name, (t, n) in top],
        "memcpy_dtoh_ms": sum(t for name, (t, _) in by_name.items()
                              if name.startswith("Memcpy DtoH")) / 1e3,
    }


def sweeps_per_solve(before: dict, after: dict) -> dict:
    """Sweeps a member-solve of each SOR wrapper that solved between two
    `sweep_counts()` readings."""
    return {name: (s - before[name][0]) / (n - before[name][1])
            for name, (s, n) in after.items() if n > before[name][1]}


def profile_rollout(run, nt: int) -> dict:
    """Steps/s (one warm-up, then the median of three timed calls of
    `run`, each `nt` steps ending in a synchronize), then one call under
    the profiler: its device idle share, top device records, top host ops,
    the device-to-host copies' time and the SOR solves' sweeps."""
    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed()  # warm-up: cuBLAS/cuFFT plans, the kernel library's build
    rates = [nt / timed() for _ in range(3)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = kernels.sweep_counts()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(RANGE):
            wall = timed()
    swept = sweeps_per_solve(before, kernels.sweep_counts())
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {
        "device": torch.cuda.get_device_name(0),
        "steps_per_s_median_of_3": statistics.median(rates),
        "steps_per_s": rates, "profiled_wall_ms": wall * 1e3,
        **device_summary(profiling.chrome_events(prof), nt),
        "top_host_self_ms": [[e.key[:80], e.self_cpu_time_total / 1e3,
                              e.count] for e in host[:6]],
        **({"sor_sweeps_per_solve": swept} if swept else {}),
    }


def profile(argv) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_run needs a CUDA device")
    t0 = time.perf_counter()
    args, device, sys_ = run_solver.build(list(argv) + ["--device", "cuda"])
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    periodic = run_solver._2D + run_solver._3D
    run = sys_.final_state if args.family in periodic else sys_.simulate
    return {"argv": list(argv), "setup_s": setup,
            **profile_rollout(run, args.nt)}


if __name__ == "__main__":
    print(json.dumps(profile(sys.argv[1:])))
