"""The traced window and what the per-layer readers take from it.

`torch.profiler` records CPU and CUDA activity over one warm-up job (which
pays the profiler's own start, outside the window) and then `count` jobs
inside a `port_bench.window` range. The Chrome trace it exports is read
back into `Trace`: the window's bounds, the device records (kernels,
copies, memsets) that start inside it, each kernel's launching call (by
correlation id), and the CPU ranges (the program's `named_scope` spans,
the harness's job spans, aten ops).

Device busy time is the union of the device records' intervals inside
the window, so records that overlap (streams, copies beside kernels)
count once; idle = 1 - busy / window.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    t0: float                       # window start, us (trace clock)
    t1: float                       # window end, us
    device: list = field(default_factory=list)   # (name, ts, dur, cat, corr)
    launch: dict = field(default_factory=dict)   # corr -> (ts, tid)
    ranges: list = field(default_factory=list)   # (name, ts, dur, tid, cat)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self):
        return [d for d in self.device if d[3] == "kernel"]

    def busy_us(self) -> float:
        return union_us([(ts, ts + dur) for _, ts, dur, _, _ in self.device],
                        self.t0, self.t1)

    def spans(self, name: str):
        return [(ts, ts + dur, tid) for n, ts, dur, tid, cat in self.ranges
                if n == name and cat == "user_annotation"]

    def launched_in(self, name: str):
        """Kernels whose launching call lies inside a CPU range `name`
        (on the thread that launched it)."""
        spans = self.spans(name)
        out = []
        for k in self.kernels():
            ts_tid = self.launch.get(k[4])
            if ts_tid and any(a <= ts_tid[0] <= b and tid == ts_tid[1]
                              for a, b, tid in spans):
                out.append(k)
        return out


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of [a, b) intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def parse(events: list) -> Trace:
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} '{WINDOW}' ranges")
    t0 = float(win[0]["ts"])
    tr = Trace(t0=t0, t1=t0 + float(win[0]["dur"]))
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            if tr.t0 <= ts < tr.t1:
                tr.device.append((e["name"], ts, dur, cat,
                                  args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                tr.launch[args["correlation"]] = (ts, e.get("tid"))
        elif cat in ("user_annotation", "cpu_op") and \
                ts < tr.t1 and ts + dur > tr.t0 and e["name"] != WINDOW:
            tr.ranges.append((e["name"], ts, dur, e.get("tid"), cat))
    return tr


def capture(run_warm, run_window, tmp_dir: str | None = None) -> Trace:
    """Profile `run_warm()` then `run_window()` inside the window range;
    the exported Chrome trace is parsed and deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_warm()
        with record_function(WINDOW):
            run_window()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmp_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def _innermost(ranges, starts, t: float) -> str | None:
    """The latest-starting of `ranges` (sorted by start) that contains t:
    of nested CPU ranges, the innermost."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        name, ts, dur = ranges[j][:3]
        if ts <= t < ts + dur:
            return name
        if t - ts > 1e6:  # no range of a traced window lasts a second
            return None
    return None


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    gaps summed by what the host was doing when each began (innermost span
    / innermost aten op), each as [name, seconds], longest first."""
    by_op = collections.Counter()
    for name, _, dur, _, _ in tr.device:
        by_op[name[:160]] += dur * 1e-6
    ivs = sorted((ts, ts + dur) for _, ts, dur, _, _ in tr.device)
    gaps, end = [], tr.t0
    for a, b in ivs:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if tr.t1 > end:
        gaps.append((end, tr.t1))
    by_cat = {}
    for cat in ("user_annotation", "cpu_op"):
        rs = sorted((r for r in tr.ranges if r[4] == cat), key=lambda r: r[1])
        by_cat[cat] = (rs, [r[1] for r in rs])
    by_host = collections.Counter()
    for a, b in gaps:
        span = _innermost(*by_cat["user_annotation"], a) or "-"
        op = _innermost(*by_cat["cpu_op"], a) or "python"
        by_host[f"{span}/{op}"[:160]] += (b - a) * 1e-6
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}


@dataclass
class Context:
    """What a per-layer reader gets: the trace, the work in the traced
    window, and the cell."""

    trace: Trace
    steps: int          # solver steps of the traced jobs
    cell: object
    route: dict
