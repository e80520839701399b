"""The 3D Taylor-Green vortex (Brachet et al. 1983) plus `perturbation`
times a seeded solenoidal field, float32 on the device:

    u = sin x cos y cos z, v = -cos x sin y cos z, w = 0,
    + eps * P[curl-free part removed from a Gaussian field band-limited by
      exp(-(|k| / k_peak)^2 / 2)], scaled to unit max speed.

Each entry draws its own Gaussian field from a generator on the device
seeded by (run seed, entry index).
"""

from __future__ import annotations

import math

import torch

from port_bench.harness.guard import entry_seed


def _k(n: int, half: bool, device) -> torch.Tensor:
    f = (torch.fft.rfftfreq if half else torch.fft.fftfreq)(n, d=1.0 / n,
                                                           device=device)
    return f.to(torch.float32)


def make(cell, seed: int, index: int, device) -> dict:
    c, t = cell.config, cell.traffic
    n = c["nx"]
    if not (c["ny"] == n and c["nz"] == n):
        raise ValueError("tg_plus_solenoidal makes cubic grids")
    g = torch.Generator(device=device)
    g.manual_seed(entry_seed(seed, index))
    a = torch.randn((3, n, n, n), generator=g, device=device,
                    dtype=torch.float32)
    kx = _k(n, False, device)[:, None, None]
    ky = _k(n, False, device)[None, :, None]
    kz = _k(n, True, device)[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    a_hat = torch.fft.rfftn(a, dim=(1, 2, 3)) * torch.exp(
        -0.5 * k2 / t["k_peak"] ** 2)
    kdot = kx * a_hat[0] + ky * a_hat[1] + kz * a_hat[2]
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    a_hat = torch.stack([a_hat[0] - kx * kdot * inv_k2,
                         a_hat[1] - ky * kdot * inv_k2,
                         a_hat[2] - kz * kdot * inv_k2])
    a_hat[:, 0, 0, 0] = 0
    pert = torch.fft.irfftn(a_hat, s=(n, n, n), dim=(1, 2, 3))
    pert = pert / pert.abs().max()
    x = torch.arange(n, device=device, dtype=torch.float32) * (2 * math.pi / n)
    sx, cx = torch.sin(x), torch.cos(x)
    tg = torch.stack([
        sx[:, None, None] * cx[None, :, None] * cx[None, None, :],
        -cx[:, None, None] * sx[None, :, None] * cx[None, None, :],
        torch.zeros((n, n, n), device=device)])
    return {"u0": (tg + t["perturbation"] * pert).contiguous()}
