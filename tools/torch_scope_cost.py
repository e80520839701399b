#!/usr/bin/env python3
"""What the port's tracing hooks cost the eager step on the card.

`solvers/chorin_fd.py`'s step wraps its predictor, pressure and correction
in `utils/profiling.py::named_scope`, `solvers/spectral3d.py` its host-side
constant builds and its nonlinear term; off a profile a scope is a
nullcontext. The SOR kernels K1, K4 and K5 add each solve's sweeps to a
counter on the card. This script times the eager step of chorin_fd
explicit and semi_implicit at 51^2 (nit 200), direct_fd at 50^2 (nit 50;
a control with no scopes), one spectral3d step at 256^3 'default' (the
fused route) and one K4 solve at 1024^2 (nit 200, tol 5e-6, from one
state each call), each under three forms, taken in turns (a b c c b a,
`rounds` times):
  - "shipped": the hooks as they are, no profiler running;
  - "none": every scope replaced by one prebuilt nullcontext (the step as
    it was before the scopes, but for the `with` statements) and no
    counter (a null pointer: the kernels skip the add);
  - "recording": every scope forced to record (record_function and an NVTX
    push and pop a scope, what a profiled step pays), the counter on.
Steps/s is `steps` steps (or solves) from one state, synchronized before
and after. Needs a CUDA device. Prints the card's name and power limit,
then one JSON line with each form's median and runs. `only` keeps the
steppers whose label starts with one of its comma-separated words. On a
tree without some hook, its form changes nothing there.

    python tools/torch_scope_cost.py [steps [rounds [only]]]
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
from ns_tpu_torch.ops import kernels  # noqa: E402
from ns_tpu_torch.ops.kernels import poisson_kernels as pk  # noqa: E402
from ns_tpu_torch.solvers import chorin_fd, direct_fd  # noqa: E402
from ns_tpu_torch.solvers import spectral3d as s3  # noqa: E402
from ns_tpu_torch.utils import profiling  # noqa: E402

NULL = contextlib.nullcontext()
COUNTER = getattr(pk, "_sweep_counter", None)
# form: (the scope, the sweep counter's address)
FORMS = {"shipped": (profiling.named_scope, COUNTER),
         "none": (lambda name: NULL, lambda device, wrapper: 0),
         "recording": (profiling._recorded_scope, COUNTER)}


def use(form: str) -> None:
    scope, counter = FORMS[form]
    chorin_fd.named_scope = s3.named_scope = scope
    if COUNTER is not None:
        pk._sweep_counter = counter


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
    g = s3.Spectral3DConfig(nx=256, ny=256, nz=256, transform="matmul",
                            matmul_precision="default",
                            use_pallas_transform="auto")
    step3, _ = s3.make_step(g, "cuda")
    out["spectral3d 256^3 default step"] = (
        lambda c: step3(c)[0],
        s3.init_from_velocity(g, s3.random_solenoidal_velocity(g, seed=1),
                              "cuda"))
    n = 1024
    h = 2.0 / (n - 1)
    gen = torch.Generator().manual_seed(2)
    p0 = torch.zeros((n, n), device="cuda")
    c = (h * h * torch.randn((n, n), generator=gen)).to("cuda")
    out["K4 solve 1024^2"] = (
        lambda s: (kernels.sor_redblack_packed_multiblock(
            s[0], s[1], h, h, 1.25, 5e-6, 200), s)[1], (p0, c))
    return out


def rate(step, s, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        s = step(s)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def main(steps: int = 1000, rounds: int = 3, only: str = "") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("torch_scope_cost needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    out = {"card": smi, "steps": steps, "rounds": rounds}
    order = list(FORMS) + list(FORMS)[::-1]
    for label, (step, s0) in steppers().items():
        if only and not label.startswith(tuple(only.split(","))):
            continue
        rate(step, s0, 50)                                   # warm-up
        runs = {f: [] for f in FORMS}
        for _ in range(rounds):
            for form in order:
                use(form)
                runs[form].append(rate(step, s0, steps))
        use("shipped")
        out[label] = {f: {"median_steps_per_s": statistics.median(r),
                          "steps_per_s": r} for f, r in runs.items()}
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    print(json.dumps(main(*map(int, argv[:2]), *argv[2:3])))
