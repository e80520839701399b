"""The FD lid-driven cavity family: `ns_tpu_torch/solvers/chorin_fd.py` as
`cli/run_solver.py` builds it (its `cavity_bcs`, `quirk_compat` on), and,
for a cell with `members`, the batch through
`parallel/ensemble.py::ensemble_fd_rollout`.

A job is one rollout of `nt_job` steps from `init_state` of the entry's
(u, v) and p = 0; it ends with a synchronize, its final (u, v, p) on the
device.
"""

from __future__ import annotations

import torch

from ns_tpu_torch.cli.run_solver import cavity_bcs
from ns_tpu_torch.parallel.ensemble import ensemble_fd_rollout
from ns_tpu_torch.solvers import chorin_fd


class ChorinFD:
    def __init__(self, cell, device):
        c, t = cell.config, cell.traffic
        self.device = torch.device(device)
        self.cfg = chorin_fd.ChorinFDConfig(
            nt=t["nt_job"], nit=c["nit"], nx=t["n"], ny=t["n"], dt=t["dt"],
            rho=c["rho"], nu=t["nu"], beta=c["beta"], method=c["method"],
            sor_tol=c["sor_tol"], quirk_compat=c["quirk_compat"],
            pressure_mode=c["pressure_mode"])
        self.dtype = getattr(torch, c["dtype"])
        self.bcs = cavity_bcs(self.cfg.dx, self.cfg.dy)
        self.step = chorin_fd.make_step(self.cfg, *self.bcs, dtype=self.dtype,
                                        device=self.device)
        self.members = t.get("members")
        self.steps_per_job = t["nt_job"]
        self.work_per_job = float(t["n"] * t["n"] * t["nt_job"]
                                  * (self.members or 1))
        self.route = {"method": self.cfg.method,
                      "pressure_mode": self.cfg.pressure_mode,
                      "members": self.members or 1,
                      "rollout": ("ensemble_fd_rollout" if self.members
                                  else "make_step loop")}

    def job(self, entry, span):
        cfg = self.cfg
        with span("job.init"):
            state = chorin_fd.init_state(cfg, entry["u0"], entry["v0"],
                                         entry["p0"], *self.bcs,
                                         dtype=self.dtype, device=self.device)
        with span("job.steps"):
            if self.members:
                state = ensemble_fd_rollout(self.step, state, cfg.nt)
            else:
                for _ in range(cfg.nt):
                    state = self.step(state)
        with span("job.sync"):
            # the benchmark's finite check, queued before the job's sync
            ok = (torch.isfinite(state.u).all() & torch.isfinite(state.v).all()
                  & torch.isfinite(state.p).all())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"u": state.u, "v": state.v, "p": state.p, "ok": ok}

    @staticmethod
    def finite(out):
        return out["ok"]

    @staticmethod
    def keep(out) -> dict:
        return {"u": out["u"], "v": out["v"], "p": out["p"]}


def build(cell, device) -> ChorinFD:
    return ChorinFD(cell, device)
