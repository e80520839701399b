"""The comparison that decides `correct`.

After the window, the sampled jobs' records (copied off the device) go to
the configuration's plain reference (`reference/<config>.py`), which is
given the same inputs, made again from the seed by the cell's input
generator. `numbers(got, ref)` gives each compared number of a job; a run
keeps the worst over its sample, and each number has its limit in the
cell file (`limits`). The control is the reference itself at the cell's
`control` precision, compared the same way.
"""

from __future__ import annotations

import math

import torch


def to_host(record: dict) -> dict:
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in record.items()}


def _worst(acc: dict, nums: dict) -> None:
    for k, v in nums.items():
        # a NaN gap is the worst gap
        acc[k] = v if (math.isnan(v) or k not in acc or math.isnan(acc[k])
                       ) else max(acc[k], v)


def readings(cell, seed: int, samples, device, rounding=None) -> dict:
    """The worst of each compared number over `samples` [(job index,
    host record)]: the program's records, or, with `rounding`, the
    reference at that precision put in the program's place."""
    ref_mod, inputs = cell.reference(), cell.inputs()
    pool = cell.traffic["pool"]
    worst: dict = {}
    for index, record in samples:
        entry = inputs.make(cell, seed, index % pool, device)
        ref = ref_mod.solve(cell, entry)
        got = record if rounding is None else ref_mod.solve(cell, entry,
                                                            rounding)
        _worst(worst, ref_mod.numbers(got, ref))
        del entry, ref, got
    return worst


def verdict(cell, values: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}}).
    The compared numbers are those the cell gives a limit; one that the
    reference did not give reads NaN and fails."""
    checks = {k: {"value": values.get(k, float("nan")), "limit": lim}
              for k, lim in sorted(cell.traffic.get("limits", {}).items())}
    ok = bool(checks) and all(math.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
