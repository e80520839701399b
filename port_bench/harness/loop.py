"""The closed loop of jobs: each job starts when the previous one has its
outputs ready, on pool entry i mod the pool's size.

A job is timed on the host clock from its start to its outputs being ready
(the family's job ends in a synchronize or a host read). The window runs
from the first job's start to the end of the last job started before the
deadline, so every job in it is whole and the window's time is all of it.
A job that raises, or whose outputs are not finite, counts as failed.
"""

from __future__ import annotations

import contextlib
import random
import time
import traceback
from dataclasses import dataclass, field

import torch

from port_bench.harness.check import to_host


@dataclass
class Window:
    """What one closed loop did."""

    seconds: float = 0.0          # first job's start to last job's end
    setup_seconds: float = 0.0
    job_seconds: list = field(default_factory=list)  # every job completed
    work: float = 0.0             # cell updates of the jobs that passed
    steps: int = 0                # solver steps of the jobs completed
    attempted: int = 0
    raised: int = 0
    flags: list = field(default_factory=list)  # finite flags, one a job
    errors: list = field(default_factory=list)

    @property
    def failed(self) -> int:
        return self.raised + sum(not bool(f) for f in self.flags)


class Reservoir:
    """A uniform sample of `k` jobs' records, drawn from the seed
    (reservoir sampling: the sample holds device tensors of at most k
    jobs at a time)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list[tuple[int, dict]] = []
        self.seen = 0

    def offer(self, index: int, record: dict) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((index, record))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (index, record)


def no_span(name: str):
    return contextlib.nullcontext()


def run_jobs(fam, pool: list, window: Window, sample: Reservoir | None,
             *, deadline: float | None = None, count: int | None = None,
             first: int = 0, span=no_span) -> Window:
    """Run jobs back to back from job index `first` until `deadline`
    (host clock) or for `count` jobs, recording into `window`."""
    i = first
    t_start = time.perf_counter()
    t_last = t_start
    while True:
        t0 = time.perf_counter()
        if (deadline is not None and t0 >= deadline) or \
                (count is not None and i - first >= count):
            break
        window.attempted += 1
        try:
            out = fam.job(pool[i % len(pool)], span)
        except Exception:  # a failed job is counted; the loop goes on
            window.raised += 1
            if len(window.errors) < 3:
                window.errors.append(traceback.format_exc())
            out = None
        t_last = time.perf_counter()
        if out is not None:
            window.job_seconds.append(t_last - t0)
            window.steps += fam.steps_per_job
            flag = fam.finite(out)
            window.flags.append(flag)
            if sample is not None:
                sample.offer(i, fam.keep(out))
        i += 1
    window.seconds += t_last - t_start
    return window


def settle_flags(window: Window, work_per_job: float) -> None:
    """Read the jobs' finite flags (0-dim device tensors or bools) to the
    host, after the window, and count the work of the jobs that passed."""
    if window.flags and isinstance(window.flags[0], torch.Tensor):
        window.flags = torch.stack(window.flags).cpu().tolist()
    window.flags = [bool(f) for f in window.flags]
    window.work = work_per_job * sum(window.flags)


def make_pool(cell, seed: int, device) -> list:
    """The cell's input pool, made on `device` from the seed."""
    make = cell.inputs().make
    return [make(cell, seed, j, device) for j in range(cell.traffic["pool"])]


def warm_up(fam, pool: list, span=no_span) -> Window:
    """One job on the pool's last entry (a window starts at entry 0)."""
    return run_jobs(fam, pool, Window(), None, count=1,
                    first=len(pool) - 1, span=span)


def sampled_outputs(fam, window: Window, sample: Reservoir) -> list:
    """After a window: its flags settled, and the sampled jobs' records
    copied off the device, [(job index, host record)]: what the
    comparison judges."""
    settle_flags(window, fam.work_per_job)
    return [(i, to_host(rec)) for i, rec in sample.items]
