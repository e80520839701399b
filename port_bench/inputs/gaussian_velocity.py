"""Cavity initial fields: u, v = `scale` * N(0, 1) on every cell (as the
FD ensembles of the port's chip checks draw them), p = 0, float32 on the
device; (B, n, n) for a cell with `members`, else (n, n). Each entry draws
from a generator on the device seeded by (run seed, entry index)."""

from __future__ import annotations

import torch

from port_bench.harness.guard import entry_seed


def make(cell, seed: int, index: int, device) -> dict:
    t = cell.traffic
    n = t["n"]
    shape = ((t["members"],) if t.get("members") else ()) + (n, n)
    g = torch.Generator(device=device)
    g.manual_seed(entry_seed(seed, index))
    uv = t["scale"] * torch.randn((2,) + shape, generator=g, device=device,
                                  dtype=torch.float32)
    return {"u0": uv[0], "v0": uv[1],
            "p0": torch.zeros(shape, device=device, dtype=torch.float32)}
