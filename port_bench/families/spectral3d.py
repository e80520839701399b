"""The 3D periodic DNS family: `ns_tpu_torch/solvers/spectral3d.py` as
`cli/run_solver.py` runs it, with the CLI's 'auto' policies.

A job is one rollout of `nt_job` steps from a physical velocity: the carry
from `init_from_velocity` (transform, Leray projection, AB2 self-start),
the step from `make_step`, then the job's diagnostics `energy`,
`enstrophy` and `divergence_max` read to the host in one copy, which ends
the job with its outputs ready.
"""

from __future__ import annotations

import math

import torch

from ns_tpu_torch.solvers import spectral3d as s3


class Spectral3D:
    def __init__(self, cell, device):
        c, t = cell.config, cell.traffic
        self.cfg = s3.Spectral3DConfig(
            nt=t["nt_job"], nx=c["nx"], ny=c["ny"], nz=c["nz"], dt=c["dt"],
            nu=c["nu"], rho=c["rho"], dealias=c["dealias"], dtype=c["dtype"],
            transform=c["transform"], matmul_precision=t["precision"],
            use_pallas_transform=c["use_pallas_transform"])
        self.step, _ = s3.make_step(self.cfg, device)
        self.steps_per_job = t["nt_job"]
        self.work_per_job = float(c["nx"] * c["ny"] * c["nz"] * t["nt_job"])
        self.route = {"transform": self.cfg.transform,
                      "use_pallas_transform": self.cfg.use_pallas_transform,
                      "matmul_precision": self.cfg.matmul_precision}

    def job(self, entry, span):
        cfg = self.cfg
        with span("job.init"):
            carry0 = s3.init_from_velocity(cfg, entry["u0"])
        carry = carry0
        with span("job.steps"):
            for _ in range(cfg.nt):
                carry, _ = self.step(carry)
        with span("job.diagnostics"):
            u_hat = carry[0]
            # the benchmark's finite check of the last nonlinear term rides
            # the diagnostics' one copy (the energy covers every mode of u)
            read = torch.stack([
                s3.energy(cfg, u_hat), s3.enstrophy(cfg, u_hat),
                s3.divergence_max(cfg, u_hat),
                torch.isfinite(torch.view_as_real(carry[1])).all().to(
                    u_hat.real.dtype)]).cpu()
        return {"carry0": carry0, "carry": carry, "diag": read[:3],
                "n_finite": bool(read[3])}

    @staticmethod
    def finite(out) -> bool:
        return out["n_finite"] and all(math.isfinite(x)
                                       for x in out["diag"].tolist())

    @staticmethod
    def keep(out) -> dict:
        return {"u_hat0": out["carry0"][0], "n0": out["carry0"][1],
                "u_hat": out["carry"][0], "n": out["carry"][1],
                "diag": out["diag"]}


def build(cell, device) -> Spectral3D:
    return Spectral3D(cell, device)
