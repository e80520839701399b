#!/usr/bin/env python3
"""What chorin_fd's three named scopes cost the eager step on the card.

`solvers/chorin_fd.py`'s step wraps its predictor, pressure and correction
in `utils/profiling.py::named_scope`. Off a profile a scope is a
nullcontext. This script times the eager step of chorin_fd explicit and
semi_implicit at 51^2 (nit 200) and, as a control that has no scopes,
direct_fd at 50^2 (nit 50), each under three forms of the scope, taken in
turns (a b c c b a, `rounds` times):
  - "shipped": named_scope as it is, no profiler running;
  - "none": every scope replaced by one prebuilt nullcontext (the step as
    it was before the scopes, but for three `with` statements);
  - "recording": every scope forced to record (record_function and an NVTX
    push and pop a scope, what a profiled step pays).
Steps/s is `steps` steps from one state, synchronized before and after.
Needs a CUDA device. Prints the card's name and power limit, then one
JSON line with each form's median and runs.

    python tools/torch_scope_cost.py [steps [rounds]]
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ns_tpu_torch.cli.run_solver import cavity_bcs  # noqa: E402
from ns_tpu_torch.core.state import FlowState  # noqa: E402
from ns_tpu_torch.solvers import chorin_fd, direct_fd  # noqa: E402
from ns_tpu_torch.utils import profiling  # noqa: E402

NULL = contextlib.nullcontext()
FORMS = {"shipped": profiling.named_scope,
         "none": lambda name: NULL,
         "recording": profiling._recorded_scope}


def steppers():
    """{label: (step, state0)} on the card."""
    out = {}
    z = np.zeros((51, 51))
    for method in ("explicit", "semi_implicit"):
        c = chorin_fd.ChorinFDConfig(nt=1, nit=200, nx=51, ny=51, dt=0.001,
                                     rho=1.0, nu=0.1, beta=1.25,
                                     method=method)
        bc = cavity_bcs(c.dx, c.dy)
        out[f"chorin_fd {method} 51^2"] = (
            chorin_fd.make_step(c, *bc, device="cuda"),
            chorin_fd.init_state(c, z, z, z, *bc, device="cuda"))
    d = direct_fd.DirectFDConfig(nt=1, nit=50, nx=50, ny=50)
    zd = torch.zeros((50, 50), device="cuda")
    out["direct_fd 50^2 (no scopes)"] = (
        direct_fd.make_step(d, *cavity_bcs(d.dx, d.dy)),
        FlowState(u=zd, v=zd, p=zd))
    return out


def rate(step, s, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        s = step(s)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def main(steps: int = 1000, rounds: int = 3) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("torch_scope_cost needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out = {"card": smi, "steps": steps, "rounds": rounds}
    order = list(FORMS) + list(FORMS)[::-1]
    for label, (step, s0) in steppers().items():
        rate(step, s0, 50)                                   # warm-up
        runs = {f: [] for f in FORMS}
        for _ in range(rounds):
            for form in order:
                chorin_fd.named_scope = FORMS[form]
                runs[form].append(rate(step, s0, steps))
        chorin_fd.named_scope = profiling.named_scope
        out[label] = {f: {"median_steps_per_s": statistics.median(r),
                          "steps_per_s": r} for f, r in runs.items()}
    return out


if __name__ == "__main__":
    print(json.dumps(main(*map(int, sys.argv[1:]))))
