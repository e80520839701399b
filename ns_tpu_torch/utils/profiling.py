"""Tracing and timing hooks.

Port of `ns_tpu/utils/profiling.py`: `named_scope` marks a solver phase in
a trace (chorin_fd's predictor, pressure and correction), `trace` records
a profile of the code inside it, `timed` is a wall-clock timer that waits
for queued device work before it reads the clock.

  - `named_scope(name)`: while a profiler runs (`trace`,
    `torch.profiler.profile`, or `torch.autograd.profiler.emit_nvtx` for
    Nsight tools), `torch.profiler.record_function(name)` plus an NVTX
    range of the same name when CUDA is present. Otherwise, and under
    `torch.export` or `torch.compile` tracing, it does nothing: the
    eager step pays no dispatcher call or NVTX push when tracing is off.
  - `trace(log_dir)`: `torch.profiler.profile` of CPU and (when present)
    CUDA activity; on exit a Chrome trace (`chrome://tracing`, Perfetto)
    is written under log_dir. The context yields the profiler.
  - `timed(fn, *args, iters, warmup, **kw)`: (mean seconds, last result),
    synchronizing after the warm-up and after the timed loop.
  - `chrome_events(prof)`, `device_window(events, name)`, `union_us`: a
    profile's device records (kernels, copies, memsets) inside one CPU
    range and the union of their intervals, so that records that overlap
    count once (`cli/profile_run.py`'s idle share).

The port's spans: `chorin_fd.predictor`, `.pressure`, `.correction`
(`solvers/chorin_fd.py`), `spectral3d.constants` (each host-side constant
build), `spectral3d.nonlinear` (`solvers/spectral3d.py`).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time
from typing import Callable

import torch

from ns_tpu_torch.utils.host import sync


@functools.lru_cache(maxsize=1)
def _nvtx() -> bool:
    return torch.cuda.is_available()


def named_scope(name: str):
    """with named_scope("pressure"): ... marks the block in a trace. Off a
    profile (no `trace`, torch.profiler.profile or emit_nvtx running) it
    is a nullcontext, so a solver step pays one flag read a scope."""
    if (not torch._C._autograd._profiler_enabled()
            or torch.compiler.is_compiling()):
        return contextlib.nullcontext()
    return _recorded_scope(name)


@contextlib.contextmanager
def _recorded_scope(name: str):
    nvtx = _nvtx()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write a Chrome trace into log_dir
    (`trace.<pid>.<ns>.json`); yields the torch.profiler.profile object."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """(mean_seconds, last_result) of fn over `iters` calls after `warmup`
    calls; the device is synchronized after the warm-up and after the
    timed loop, so queued kernels cannot fake the number."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _wait(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    _wait(result)
    return (time.perf_counter() - t0) / iters, result


def _wait(result) -> None:
    """sync(result), and the current CUDA device when CUDA is in use (fn
    may queue work that its result does not hold)."""
    sync(result)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of [a, b) intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def chrome_events(prof) -> list:
    """The events of a finished `torch.profiler.profile`, as its Chrome
    trace holds them (the trace file is written and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def device_window(events: list, name: str) -> dict:
    """The device's work inside the one CPU range `name` of a Chrome
    trace: the range's `t0` and `t1`, the device records (kernels, copies,
    memsets; `(name, ts, dur)`) that start inside it, and `busy_us`, the
    union of their intervals clipped to it (trace clock, us)."""
    rng = [e for e in events if e.get("name") == name
           and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if len(rng) != 1:
        raise ValueError(f"the trace holds {len(rng)} '{name}' ranges")
    t0 = float(rng[0]["ts"])
    t1 = t0 + float(rng[0]["dur"])
    records = [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
               for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS and t0 <= float(e["ts"]) < t1]
    busy = union_us([(ts, ts + dur) for _, ts, dur in records], t0, t1)
    return {"t0": t0, "t1": t1, "records": records, "busy_us": busy}
