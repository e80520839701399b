"""Plain reference of the 3D periodic DNS configuration, float64, from the
equations:

    du/dt = P[u x omega] - nu k^2 u,    P(k) = I - k k^T / k^2,

integrating factor E = exp(-nu k^2 dt) with Adams-Bashforth-2:

    u^{n+1} = E u^n + dt (3/2 E N^n - 1/2 E^2 N^{n-1}),

N = P[F(u x omega)] with the mean mode 0, the history self-started with
N(u^0); u^0 = P[F(u0)]. The spectra keep the 2/3 rule's modes only,
|k_x|, |k_y| < n/3 and 0 <= k_z < n/3 (the compact layout), so a
spectrum compares mode for mode with the program's carry.

F and its inverse are the exact DFT sums, one axis at a time, written as
matrix products (z on the real field, then y, then x; back in the
reverse order, the z-stage unfolding the half spectrum: weight 1 at
k_z = 0, 2 elsewhere, real part). `rounding` (the control) rounds both
inputs of every such product to a lower precision (harness/lowp.py) and
keeps the sums in float64: a DFT-by-GEMM engine at that precision, with
wide accumulation as tensor cores keep it.
"""

from __future__ import annotations

import math

import torch

from port_bench.harness.lowp import rounder

F64, C128 = torch.float64, torch.complex128


def _freqs(n: int) -> torch.Tensor:
    return torch.tensor([k if k <= n // 2 else k - n for k in range(n)],
                        dtype=F64)


class _Engine:
    def __init__(self, n: int, nu: float, dt: float, rounding, device):
        k = _freqs(n)
        rows = torch.nonzero(k.abs() < n / 3).flatten()
        kzc = sum(1 for j in range(n // 2 + 1) if j < n / 3)
        kk, kz = k[rows], torch.arange(kzc, dtype=F64)
        j = torch.arange(n, dtype=F64)
        phase = lambda a, b: torch.exp(-2j * math.pi * torch.outer(a, b) / n)
        c = torch.full((kzc,), 2.0, dtype=F64)
        c[0] = 1.0
        on = lambda t: t.to(device)
        self.n = n
        self.Wz = on(phase(j, kz))                            # (n, kzc)
        self.Wy = self.Wx = on(phase(kk, j))                  # (r, n)
        self.Wyi = self.Wxi = on(phase(kk, j).conj().T / n)   # (n, r)
        self.Bz = on(c[:, None] * phase(kz, j).conj() / n)    # (kzc, n)
        self.kx = on(kk)[:, None, None]
        self.ky = on(kk)[None, :, None]
        self.kz = on(kz)[None, None, :]
        k2 = self.kx ** 2 + self.ky ** 2 + self.kz ** 2
        self.inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                                  0.0)
        self.E = torch.exp(-nu * k2 * dt)
        self.w = on(c)[None, None, :]  # conjugate-pair weights of k_z
        self.rd = rounder(rounding)

    def mm(self, a, b):
        """a @ b with both inputs rounded; complex as real products."""
        a, b = self.rd(a), self.rd(b)
        if not a.is_complex():
            return torch.complex(a @ b.real, a @ b.imag)
        if not b.is_complex():
            return torch.complex(a.real @ b, a.imag @ b)
        return a @ b

    def fwd(self, f):
        """Real (..., n, n, n) -> compact spectrum (..., r, r, kzc)."""
        n = self.n
        a = self.mm(f, self.Wz)                        # (..., n, n, kzc)
        a = self.mm(self.Wy, a)                        # (..., n, r, kzc)
        lead = a.shape[:-3]
        r, kzc = a.shape[-2:]
        a = self.mm(self.Wx, a.reshape(*lead, n, r * kzc))
        return a.reshape(*lead, -1, r, kzc)

    def inv(self, z):
        """Compact spectrum -> real (..., n, n, n)."""
        n = self.n
        lead, (r, r2, kzc) = z.shape[:-3], z.shape[-3:]
        a = self.mm(self.Wxi, z.reshape(*lead, r, r2 * kzc))
        a = self.mm(self.Wyi, a.reshape(*lead, n, r2, kzc))  # (..., n, n, kzc)
        a, bz = self.rd(a), self.rd(self.Bz)
        return a.real @ bz.real - a.imag @ bz.imag

    def ik(self, k, z):
        return 1j * k * z

    def curl(self, u):
        return torch.stack([self.ik(self.ky, u[2]) - self.ik(self.kz, u[1]),
                            self.ik(self.kz, u[0]) - self.ik(self.kx, u[2]),
                            self.ik(self.kx, u[1]) - self.ik(self.ky, u[0])])

    def leray(self, v):
        kdot = (self.kx * v[0] + self.ky * v[1] + self.kz * v[2]) * self.inv_k2
        return torch.stack([v[0] - self.kx * kdot, v[1] - self.ky * kdot,
                            v[2] - self.kz * kdot])

    def half_energy(self, z):
        """(1/2) <|f|^2> of the real field with compact spectrum z
        (Parseval over the kept modes, conjugate pairs counted twice)."""
        return 0.5 * ((z.real ** 2 + z.imag ** 2) * self.w).sum() / self.n ** 6


def solve(cell, inputs: dict, rounding: str | None = None) -> dict:
    """The job's outputs as the program's record holds them: the init's
    carry (u_hat0, n0) and the final one (u_hat, n), compact complex128,
    and the final state's (energy, enstrophy, divergence_max)."""
    c, t = cell.config, cell.traffic
    u0 = inputs["u0"].to(F64)
    g = _Engine(c["nx"], c["nu"], c["dt"], rounding, u0.device)

    def nonlinear(u_hat):
        u, w = g.inv(u_hat), g.inv(g.curl(u_hat))
        lamb = torch.stack([u[1] * w[2] - u[2] * w[1],
                            u[2] * w[0] - u[0] * w[2],
                            u[0] * w[1] - u[1] * w[0]])
        del u, w
        N = g.leray(g.fwd(lamb))
        N[:, 0, 0, 0] = 0
        return N

    u_hat = g.leray(g.fwd(u0))
    N_prev = nonlinear(u_hat)
    out = {"u_hat0": u_hat, "n0": N_prev}
    for _ in range(t["nt_job"]):
        N = nonlinear(u_hat)
        u_hat = g.E * u_hat + c["dt"] * (1.5 * g.E * N
                                         - 0.5 * g.E * g.E * N_prev)
        N_prev = N
    div_hat = (g.ik(g.kx, u_hat[0]) + g.ik(g.ky, u_hat[1])
               + g.ik(g.kz, u_hat[2]))
    out.update(u_hat=u_hat, n=N_prev, diag=torch.stack([
        g.half_energy(u_hat), g.half_energy(g.curl(u_hat)),
        g.inv(div_hat).abs().max()]))
    return {k: v.cpu() for k, v in out.items()}


def _rel_max(a, b) -> float:
    """max|a - b| / max|b|."""
    a, b = a.to(C128), b.to(C128)
    return float((a - b).abs().max() / b.abs().max())


def numbers(got: dict, ref: dict) -> dict:
    """The compared numbers of one job, each a relative gap to the
    reference: the init's carry, the change the steps made, the last
    nonlinear term, the diagnostics, and the divergence against the rms
    vorticity."""
    d_got = got["u_hat"].to(C128) - got["u_hat0"].to(C128)
    d_ref = ref["u_hat"] - ref["u_hat0"]
    e, z, div = (float(x) for x in got["diag"])
    e_r, z_r, div_r = (float(x) for x in ref["diag"])
    return {
        "init_u": _rel_max(got["u_hat0"], ref["u_hat0"]),
        "init_n": _rel_max(got["n0"], ref["n0"]),
        "steps_du": _rel_max(d_got, d_ref),
        "final_n": _rel_max(got["n"], ref["n"]),
        "energy": abs(e - e_r) / e_r,
        "enstrophy": abs(z - z_r) / z_r,
        "divergence": abs(div - div_r) / (2.0 * z_r) ** 0.5,
    }
