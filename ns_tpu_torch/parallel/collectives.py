"""The port's collectives over one mesh dim, each counted.

Every collective of the sharded solvers goes through this module, so the
communication budgets of the JAX package (one all_to_all a 2D transform,
two ppermutes a halo exchange, nothing on the ensemble axis;
`tests/test_collectives.py`) can be held at run time: `COUNTS` counts
each call by kind and by kind@axis. With an initialized process group a
collective runs on the mesh dim's subgroup, whatever its size (a world of
1 on NCCL still goes through NCCL); without one the mesh is a world of 1
and the collective is the identity.

  - `all_to_all(a, mesh, axis, split_dim, concat_dim)`: JAX's
    lax.all_to_all(..., tiled=True): `a` is cut into n blocks along
    split_dim, block j goes to the rank at coordinate j, and the received
    blocks are joined along concat_dim in coordinate order. One
    `dist.all_to_all_single` on one contiguous buffer (complex tensors as
    their real view).
  - `all_gather(a, mesh, axis, dim)`: JAX's lax.all_gather(...,
    tiled=True): every rank's block, joined along dim in coordinate
    order. One `dist.all_gather_into_tensor` on one contiguous buffer
    (complex tensors as their real view).
  - `all_reduce_sum(t, mesh, axis)`: the sum over the axis (JAX's psum).
  - `all_reduce_max(t, mesh, axis)`: the maximum over the axis (JAX's
    pmax), counted as an all_reduce, as JAX lowers pmax to one.
  - `permute_edges(send_lo, send_hi, mesh, axis)`: one
    `dist.batch_isend_irecv` that sends send_lo to the lower neighbour and
    send_hi to the upper one, and returns what they sent (zeros at the
    ends of the chain, as ppermute delivers them). Counted as two
    collective_permutes, as JAX's halo exchange is two ppermutes.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.parallel.mesh import axis_index, axis_peer, axis_size

COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _count(kind: str, axis: str, n: int = 1) -> None:
    COUNTS[kind] += n
    COUNTS[f"{kind}@{axis}"] += n


def _group(mesh: DeviceMesh, axis: str):
    """The axis's process group, or None without one (a world of 1:
    make_mesh builds no bigger mesh without a process group)."""
    return mesh.get_group(axis) if dist.is_initialized() else None


def all_to_all(a: torch.Tensor, mesh: DeviceMesh, axis: str,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled all_to_all of `a` over the mesh dim `axis`."""
    _count("all_to_all", axis)
    group = _group(mesh, axis)
    n = axis_size(mesh, axis)
    split_dim %= a.dim()
    concat_dim %= a.dim()
    if a.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {a.shape[split_dim]} "
                         f"does not split over {n} ranks")
    # the n blocks leading: (n, ..., size/n, ...), one contiguous buffer
    buf = a.unflatten(split_dim, (n, a.shape[split_dim] // n))
    buf = buf.movedim(split_dim, 0).contiguous()
    if group is not None:
        real = torch.view_as_real(buf) if buf.is_complex() else buf
        out = torch.empty_like(real)
        dist.all_to_all_single(out, real, group=group)
        buf = torch.view_as_complex(out) if buf.is_complex() else out
    # block j came from coordinate j: join the blocks along concat_dim
    return buf.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


def all_gather(a: torch.Tensor, mesh: DeviceMesh, axis: str,
               dim: int) -> torch.Tensor:
    """JAX's tiled all_gather of `a` over the mesh dim `axis`: the n
    blocks joined along `dim` in coordinate order."""
    _count("all_gather", axis)
    group = _group(mesh, axis)
    dim %= a.dim()
    if group is None:
        return a.clone()
    n = axis_size(mesh, axis)
    src = a.contiguous()
    real = torch.view_as_real(src) if src.is_complex() else src
    # the blocks concatenated along dim 0, then viewed as (n, *shape)
    out = real.new_empty((n * real.shape[0], *real.shape[1:]))
    # all_gather_single where torch has it (all_gather_into_tensor's
    # successor)
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, real, group=group)
    out = out.view(n, *real.shape)
    buf = torch.view_as_complex(out) if src.is_complex() else out
    # block j came from coordinate j: join the blocks along dim
    return buf.movedim(0, dim).flatten(dim, dim + 1)


def _all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str,
                op) -> torch.Tensor:
    _count("all_reduce", axis)
    out = t.clone()
    group = _group(mesh, axis)
    if group is not None:
        dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh,
                   axis: str) -> torch.Tensor:
    """The sum of `t` over the ranks of `axis` (a new tensor)."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, mesh: DeviceMesh,
                   axis: str) -> torch.Tensor:
    """The maximum of `t` over the ranks of `axis` (a new tensor)."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.MAX)


def permute_edges(send_lo: torch.Tensor, send_hi: torch.Tensor,
                  mesh: DeviceMesh, axis: str):
    """(from_lo, from_hi): the upper edge of the lower neighbour and the
    lower edge of the upper neighbour along `axis` (zeros where there is
    none); this rank sends send_lo down and send_hi up."""
    _count("collective_permute", axis, 2)
    group = _group(mesh, axis)
    from_lo = torch.zeros_like(send_hi)
    from_hi = torch.zeros_like(send_lo)
    i, n = axis_index(mesh, axis), axis_size(mesh, axis)
    ops = []
    if group is not None and i + 1 < n:
        peer = axis_peer(mesh, axis, i + 1)
        ops += [dist.P2POp(dist.isend, send_hi.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_hi, peer, group)]
    if group is not None and i > 0:
        peer = axis_peer(mesh, axis, i - 1)
        ops += [dist.P2POp(dist.isend, send_lo.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_lo, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_lo, from_hi
