"""Device meshes, shardings and rank-local global arrays.

Port of `ns_tpu/parallel/mesh.py`. The JAX package drives many devices
from one process; the port runs one rank per process and one device per
rank (the process group's idiom: NCCL on CUDA, gloo on the CPU), so a
mesh's "devices" are the ranks of the process group.

  - A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
    dims (`make_mesh`). A world of 1 needs no initialized process group:
    the mesh is then built without one, and every collective over it is
    the identity (the single-card path).
  - A `Sharding` is a mesh plus a spec, one mesh dim name (or None) per
    array dim, as JAX's NamedSharding(mesh, PartitionSpec(...)). Each
    rank owns one contiguous block of a sharded array.
  - A `GlobalArray` is a rank's local block with its global index and the
    global shape (what JAX's global jax.Array shows one process of).
    Collectives are explicit (`parallel/collectives.py`), never DTensor's,
    so every one of them is counted.

Axis vocabulary, as in the JAX package:
  ensemble  data-parallel axis over independent trajectories / batch
  x         spatial decomposition of field rows (halo-exchange domain)
  y         optional second spatial axis
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.core.device import resolve_device

# named presets: axis layout per target topology (the JAX package's names)
MESH_PRESETS: dict[str, dict[str, int]] = {
    # 32-chip v4 pod slice: 8-way ensembles x 4-way spatial rows
    "v4-32": {"ensemble": 8, "x": 4},
    # one host of 8: 4-way ensembles x 2-way spatial
    "host-8": {"ensemble": 4, "x": 2},
    # single device
    "single": {"ensemble": 1, "x": 1},
}


def _device_type() -> str:
    """The ranks' device type: the process group's (NCCL: cuda, gloo:
    cpu), or, without one, CUDA unless the machine has no card (then the
    caller must pass device_type='cpu'; core/device.py)."""
    if dist.is_initialized():
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return resolve_device(None).type


def make_mesh(axes: Mapping[str, int] | str | None = None,
              devices: Sequence[int] | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A mesh from {axis_name: size} (or a preset name) over `devices`
    (global ranks; default every rank of the world, one device each).
    Sizes must multiply to the device count; axes=None puts every device
    on an 'ensemble' axis. device_type defaults to the process group's
    (without one, 'cuda'; pass 'cpu' to build a CPU mesh)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(world))
    if isinstance(axes, str):
        axes = MESH_PRESETS[axes]
    if axes is None:
        axes = {"ensemble": len(ranks)}
    sizes = tuple(axes.values())
    if int(np.prod(sizes)) != len(ranks):
        raise ValueError(
            f"mesh axes {dict(axes)} need {int(np.prod(sizes))} devices, "
            f"have {len(ranks)}")
    device_type = device_type or _device_type()
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(sizes)
    names = tuple(axes.keys())
    if dist.is_initialized():
        return DeviceMesh(device_type, layout, mesh_dim_names=names)
    try:  # a world of 1: no process group, no backend
        return DeviceMesh(device_type, layout, mesh_dim_names=names,
                          _init_backend=False, _rank=0)
    except TypeError:  # a torch without the _rank keyword
        return DeviceMesh(device_type, layout, mesh_dim_names=names,
                          _init_backend=False)


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """{axis name: size} of a mesh (JAX's `mesh.shape`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return axis_sizes(mesh)[axis]


# The rank layout and coordinates of a mesh, once a mesh: DeviceMesh.mesh
# builds its tensor anew on every access (~45-150 us of host in torch 2.13),
# and a sharded step asks for coordinates at every collective.
@functools.lru_cache(maxsize=64)
def _layout(mesh: DeviceMesh) -> torch.Tensor:
    return mesh.mesh


@functools.lru_cache(maxsize=256)
def _coordinate(mesh: DeviceMesh, rank: int) -> Optional[tuple]:
    hit = (_layout(mesh) == rank).nonzero()
    return tuple(int(c) for c in hit[0]) if len(hit) else None


def axis_index(mesh: DeviceMesh, axis: str, rank: int | None = None) -> int:
    """This rank's (or `rank`'s) coordinate along `axis` (JAX's
    lax.axis_index)."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    coord = _coordinate(mesh, rank)
    if coord is None:
        raise ValueError(f"rank {rank} is not in the mesh")
    return coord[mesh.mesh_dim_names.index(axis)]


def axis_peer(mesh: DeviceMesh, axis: str, index: int) -> int:
    """The global rank at coordinate `index` along `axis`, this rank's
    coordinates along the other axes."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    coord = list(_coordinate(mesh, rank))
    coord[mesh.mesh_dim_names.index(axis)] = index
    return int(_layout(mesh)[tuple(coord)])


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def member_range(n: int, mesh: DeviceMesh | None,
                 axis: str = "ensemble") -> tuple[int, int]:
    """[lo, hi) of the n members this rank holds: its contiguous share
    along `axis` (all of them without a mesh)."""
    if mesh is None:
        return 0, n
    k = axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"{n} members do not divide over {k} ranks of "
                         f"axis {axis!r}")
    i = axis_index(mesh, axis)
    return i * (n // k), (i + 1) * (n // k)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and one mesh dim (or None: replicated) per array dim."""

    mesh: DeviceMesh
    spec: tuple

    def index(self, global_shape, rank: int | None = None) -> tuple:
        """((start, stop), ...) of the block `rank` (default: this rank)
        owns of an array of `global_shape`."""
        out = []
        for d, n in enumerate(global_shape):
            ax = self.spec[d] if d < len(self.spec) else None
            if ax is None:
                out.append((0, n))
                continue
            k = axis_size(self.mesh, ax)
            if n % k:
                raise ValueError(f"dim {d} of size {n} does not divide "
                                 f"over {k} ranks of axis {ax!r}")
            i = axis_index(self.mesh, ax, rank)
            out.append((i * (n // k), (i + 1) * (n // k)))
        return tuple(out)

    def global_shape(self, local_shape) -> tuple:
        return tuple(n * (axis_size(self.mesh, self.spec[d])
                          if d < len(self.spec) and self.spec[d] else 1)
                     for d, n in enumerate(local_shape))


@dataclasses.dataclass
class GlobalArray:
    """One rank's block of a global array: `local` covers `index` (a
    (start, stop) pair per dim) of an array of `shape`."""

    local: torch.Tensor
    index: tuple
    shape: tuple
    sharding: Sharding


def shard(sharding: Sharding, full) -> GlobalArray:
    """The rank's block of an array every rank holds in full (the port's
    jax.device_put(full, sharding)), on the mesh's device."""
    full = torch.as_tensor(full)
    idx = sharding.index(full.shape)
    block = full[tuple(slice(a, b) for a, b in idx)]
    return GlobalArray(block.to(mesh_device(sharding.mesh)).contiguous(),
                       idx, tuple(full.shape), sharding)


def wrap(sharding: Sharding, local: torch.Tensor) -> GlobalArray:
    """A local block as the rank's part of the global array it shards."""
    shape = sharding.global_shape(local.shape)
    return GlobalArray(local, sharding.index(shape), shape, sharding)
