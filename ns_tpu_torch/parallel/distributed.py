"""Multi-process runtime: bootstrap, global arrays, per-rank I/O.

Port of `ns_tpu/parallel/distributed.py`. One process per rank and one
device per rank: `initialize` maps the JAX package's NS_TPU_* bootstrap
variables (set by `python -m ns_tpu_torch.launch`, the same names the JAX
launcher sets, so launch scripts carry over) onto
`torch.distributed.init_process_group`: NCCL on 'cuda' (the rank's device
is cuda:LOCAL_RANK), gloo on 'cpu'. Under torchrun's variables
(MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE) it takes those instead.

A global array is a rank's local block with its global index
(`parallel/mesh.py::GlobalArray`): `global_array` builds one from the
rank's block of host data, `replicated` from data every rank holds,
`local_shards` reads the rank's blocks back. `save_array_shards` writes
only this rank's blocks to `<name>.proc%04d.npz` with the JAX package's
manifest, and `assemble_shards` reassembles the global array from every
rank's file (with the same hole and stale-process-count checks): files
written by either package assemble in the other.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.launch import ONE_DEVICE
from ns_tpu_torch.parallel.mesh import (GlobalArray, Sharding, make_mesh,
                                        axis_index, axis_size, mesh_device)

_ENV_PREFIX = "NS_TPU"


def _env_int(name: str):
    return int(os.environ[name]) if name in os.environ else None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               platform: str | None = None,
               local_device_count: int | None = None) -> torch.device:
    """Join the process group; returns this rank's device.

    Explicit arguments win; otherwise NS_TPU_COORDINATOR (host:port, or a
    tcp:// or file:// URL) / NS_TPU_NUM_PROCESSES / NS_TPU_PROCESS_ID /
    NS_TPU_PLATFORM / NS_TPU_LOCAL_DEVICES are read, then torchrun's
    MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE. platform 'cuda' (the default)
    takes NCCL on cuda:LOCAL_RANK (raises without a card), 'cpu' gloo.
    local_device_count other than 1 is refused (ONE_DEVICE)."""
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get(f"{_ENV_PREFIX}_COORDINATOR"))
    if num_processes is None:
        num_processes = _env_int(f"{_ENV_PREFIX}_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int(f"{_ENV_PREFIX}_PROCESS_ID")
    platform = platform or env.get(f"{_ENV_PREFIX}_PLATFORM") or "cuda"
    if local_device_count is None:
        local_device_count = _env_int(f"{_ENV_PREFIX}_LOCAL_DEVICES")
    if local_device_count not in (None, 1):
        raise ValueError(f"{local_device_count} devices per process: "
                         f"{ONE_DEVICE}")
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = num_processes or _env_int("WORLD_SIZE")
        process_id = process_id if process_id is not None else _env_int(
            "RANK")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "no coordinator: run under `python -m ns_tpu_torch.launch`, or "
            "set NS_TPU_COORDINATOR, NS_TPU_NUM_PROCESSES and "
            "NS_TPU_PROCESS_ID (or torchrun's MASTER_ADDR, MASTER_PORT, "
            "RANK and WORLD_SIZE)")
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"platform must be cuda|cpu, got {platform!r}")
    if platform == "cuda":
        resolve_device("cuda")  # no card: raise, never fall back
        local = _env_int("LOCAL_RANK")
        local = process_id % torch.cuda.device_count() if local is None \
            else local
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if platform == "cuda" else "gloo",
                            init_method=url, world_size=num_processes,
                            rank=process_id)
    return device


def initialize_from_env() -> torch.device:
    """`initialize()` from the environment only (worker entry point)."""
    return initialize()


def shutdown() -> None:
    """Leave the process group (every rank)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def barrier(name: str = "ns_tpu_barrier") -> None:
    """Block until every rank reaches this point (`name` is for parity
    with the JAX package's named sync points)."""
    del name
    if dist.is_initialized():
        dist.barrier()


def make_global_mesh(axes: Mapping[str, int] | str | None = None):
    """A mesh over every rank of the world (make_mesh's axes and
    presets)."""
    return make_mesh(axes)


def global_array(sharding: Sharding, local_data) -> GlobalArray:
    """A global array on `sharding` from this rank's block of the data
    (the multi-process device_put): `local_data` is the contiguous slab
    this rank owns, e.g. rows [r*nx/P : (r+1)*nx/P] of a row-sharded
    field over P ranks (`process_local_rows`)."""
    local = torch.as_tensor(np.asarray(local_data)
                            if not isinstance(local_data, torch.Tensor)
                            else local_data)
    local = local.to(mesh_device(sharding.mesh)).contiguous()
    shape = sharding.global_shape(local.shape)
    return GlobalArray(local, sharding.index(shape), shape, sharding)


def replicated(sharding_or_mesh, data) -> GlobalArray:
    """A fully replicated global array from host data every rank holds
    (constants every shard reads)."""
    mesh = (sharding_or_mesh.mesh if isinstance(sharding_or_mesh, Sharding)
            else sharding_or_mesh)
    local = torch.as_tensor(np.asarray(data)).to(mesh_device(mesh))
    shape = tuple(local.shape)
    return GlobalArray(local, tuple((0, n) for n in shape), shape,
                       Sharding(mesh, (None,) * len(shape)))


def local_shards(arr: GlobalArray) -> list[tuple[tuple, np.ndarray]]:
    """This rank's blocks as (global_index, numpy) pairs; global_index is
    a (start, stop) pair per dim. One block a rank."""
    return [(tuple(arr.index), arr.local.detach().cpu().numpy())]


def save_array_shards(folder: str, name: str, arr: GlobalArray) -> str:
    """Per-rank sharded output: each rank writes only its blocks to
    `folder/name.proc{rank:04d}.npz` (arrays shard0.., and a JSON manifest
    of global indices and the full shape, the JAX package's format). No
    gather, no rank holding the full array. Reassemble with
    `assemble_shards`."""
    os.makedirs(folder, exist_ok=True)
    pid = process_index()
    shards = local_shards(arr)
    manifest = {
        "name": name,
        "process": pid,
        "num_processes": process_count(),
        "global_shape": list(arr.shape),
        "dtype": str(shards[0][1].dtype),
        "shards": [{"key": f"shard{i}", "index": [list(se) for se in idx]}
                   for i, (idx, _) in enumerate(shards)],
    }
    path = os.path.join(folder, f"{name}.proc{pid:04d}.npz")
    arrays = {f"shard{i}": data for i, (_, data) in enumerate(shards)}
    np.savez(path, __manifest__=np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8), **arrays)
    return path


def assemble_shards(folder: str, name: str) -> np.ndarray:
    """Reassemble the global array from every rank's shard file.
    Replicated or overlapping blocks overwrite identically; raises if any
    cell was never covered, or if the files disagree on how many
    processes wrote the set (stale files of an earlier run)."""
    files = sorted(glob.glob(os.path.join(folder, f"{name}.proc*.npz")))
    if not files:
        raise FileNotFoundError(f"no shard files for {name!r} in {folder}")
    full = None
    covered = None
    for f in files:
        data = np.load(f)
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        if manifest["num_processes"] != len(files):
            raise ValueError(
                f"{f} says {name!r} was written by "
                f"{manifest['num_processes']} processes but {len(files)} "
                f"shard files are present — stale shard files from a "
                f"previous run? Clean {folder} and re-run")
        if full is None:
            full = np.zeros(manifest["global_shape"],
                            dtype=np.dtype(manifest["dtype"]))
            covered = np.zeros(manifest["global_shape"], dtype=bool)
        for rec in manifest["shards"]:
            sl = tuple(slice(a, b) for a, b in rec["index"])
            full[sl] = data[rec["key"]]
            covered[sl] = True
    if not covered.all():
        raise ValueError(f"shard files for {name!r} do not cover the full "
                         f"array ({covered.sum()}/{covered.size} cells)")
    return full


def process_local_rows(n_rows: int, mesh, axis: str = "x",
                       pid: int | None = None) -> tuple[int, int]:
    """The [start, stop) global rows rank `pid` (default: this rank) owns
    of an array row-sharded over `axis` of `mesh`."""
    pid = process_index() if pid is None else pid
    if not bool((mesh.mesh == pid).any()):
        raise ValueError(f"process {pid} owns no rows on axis {axis!r}")
    k = axis_size(mesh, axis)
    if n_rows % k:
        raise ValueError(f"{n_rows} rows do not divide over {k} ranks of "
                         f"axis {axis!r}")
    i = axis_index(mesh, axis, pid)
    return i * (n_rows // k), (i + 1) * (n_rows // k)
