"""Halo exchange for spatially sharded FD stencils.

Port of `ns_tpu/parallel/halo.py`: a 1-cell halo exchange over one mesh
dim, where the JAX package writes two ppermutes inside shard_map. Here a
rank exchanges contiguous edge copies with its neighbours in one
`dist.batch_isend_irecv` (`parallel/collectives.py::permute_edges`).

Convention: fields are sharded along axis 0 ("rows") on a named mesh dim.
The domain is non-periodic (cavity flows): the ends of the chain receive
zeros, as ppermute delivers them, and the physical-boundary shards
overwrite their edge rows with the BCs afterwards, so the zero halos are
never read.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.parallel.collectives import permute_edges
from ns_tpu_torch.parallel.mesh import axis_index, axis_size


def exchange_halo_rows(a: torch.Tensor, mesh: DeviceMesh,
                       axis: str) -> torch.Tensor:
    """(bx, ny) local block -> (bx+2, ny) padded with neighbour edge rows.

    Row 0 of the pad is the lower neighbour's last row (zeros on the first
    shard); row -1 is the upper neighbour's first row (zeros on the last
    shard)."""
    from_below, from_above = permute_edges(a[:1], a[-1:], mesh, axis)
    return torch.cat([from_below, a, from_above], dim=0)


def exchange_halo_cols(a: torch.Tensor, mesh: DeviceMesh,
                       axis: str) -> torch.Tensor:
    """(bx, by) local block -> (bx, by+2) padded with neighbour edge
    columns (the axis-1 analogue of exchange_halo_rows)."""
    from_left, from_right = permute_edges(a[:, :1], a[:, -1:], mesh, axis)
    return torch.cat([from_left, a, from_right], dim=1)


def global_row_index(bx: int, mesh: DeviceMesh, axis: str,
                     device=None) -> torch.Tensor:
    """(bx, 1) global row indices of this shard's rows."""
    local = torch.arange(bx, dtype=torch.int32, device=device)[:, None]
    return local + axis_index(mesh, axis) * bx


def is_first(mesh: DeviceMesh, axis: str) -> bool:
    return axis_index(mesh, axis) == 0


def is_last(mesh: DeviceMesh, axis: str) -> bool:
    return axis_index(mesh, axis) == axis_size(mesh, axis) - 1
