"""Ensembles of independent solver rollouts (data parallel).

Port of `ns_tpu/parallel/ensemble.py`. The spectral step is
batch-polymorphic (transforms act on the trailing two axes, constants
broadcast), so a (B, nx, ny) batch of vorticities rolls out as one carry.
The FD steps (`chorin_fd.make_step`, `direct_fd.make_step`) are
batch-polymorphic too, as the JAX package's are under vmap: the kernels
K1, K2 and K3 run the whole batch in one launch a step (a member on each
block, or block plane), with each member's own SOR gate, so
`ensemble_fd_rollout` calls the step once a time step on the whole share.
Their GEMM stages and the host-gated pressure modes run member by member
inside the step, and each member's final state is its own single
rollout's, bitwise. A step that does not say it takes a batch
(`batch_polymorphic`) steps the members one after another.

With a mesh, each rank takes its contiguous share of the members along
the 'ensemble' dim (`parallel/mesh.py::member_range`) and the rollouts
make no collective; `ensemble_energy`'s mean over the members is the only
one (one all-reduce). Without a mesh every member runs on `device`
(default: a batch tensor's own device, the card for host data;
core/device.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.parallel.collectives import all_reduce_sum
from ns_tpu_torch.parallel.mesh import member_range, mesh_device
from ns_tpu_torch.solvers import spectral_periodic as sp


def _share(batch, mesh, axis, device):
    """The rank's contiguous share of a batch (numpy or tensor, leading
    member axis), on the mesh's device; without a mesh on `device`, or,
    when that is None, on the tensor's own device (CUDA for host data)."""
    lo, hi = member_range(len(batch), mesh, axis)
    part = batch[lo:hi]
    if mesh is not None:
        dev = mesh_device(mesh)
    elif device is None and isinstance(part, torch.Tensor):
        dev = part.device
    else:
        dev = resolve_device(device)
    if not isinstance(part, torch.Tensor):
        part = torch.as_tensor(np.ascontiguousarray(part))
    return part.to(dev)


def ensemble_init(cfg: sp.SpectralPeriodicConfig, w0_batch,
                  mesh: DeviceMesh | None = None, axis: str = "ensemble",
                  device=None):
    """(B, nx, ny) physical vorticity batch -> the carry of this rank's
    members, for whichever engine cfg selects (carry_from_vorticity is
    batch-polymorphic); ensemble_rollout_final dispatches on the same
    flags."""
    w0 = _share(w0_batch, mesh, axis, device).to(cfg.real_dtype)
    return sp.carry_from_vorticity(cfg, w0)


def ensemble_rollout_final(cfg: sp.SpectralPeriodicConfig, carry):
    """The batched cfg.nt-step rollout of a carry; the final carry."""
    return sp.rollout_final(cfg, carry)


def ensemble_energy(cfg: sp.SpectralPeriodicConfig, w_spec_batch,
                    mesh: DeviceMesh | None = None,
                    axis: str = "ensemble") -> torch.Tensor:
    """Mean kinetic energy over the ensemble (all ranks' members), a 0-dim
    tensor. Accepts any engine's carry spectrum (rfft2, compact,
    real_gemm): a compact carry is mapped to physical vorticity, then to
    the rfft2 spectrum the velocity recovery expects. With a mesh, one
    all-reduce of (sum, count)."""
    ops = sp.make_ops(cfg, w_spec_batch.device)
    w = torch.as_tensor(sp.hermitian_weights(cfg.ny), dtype=cfg.real_dtype,
                        device=w_spec_batch.device)
    if cfg.compact_spectrum or cfg.real_gemm:
        w_hat = torch.fft.rfft2(sp.physical_from_carry(cfg, w_spec_batch))
    else:
        w_hat = w_spec_batch  # padded engines: the carry IS the spectrum
    u_hat, v_hat = sp.velocity_from_vorticity_hat(w_hat, ops)
    per = torch.sum((u_hat.abs() ** 2 + v_hat.abs() ** 2) * w, dim=(-2, -1))
    per = per.reshape(-1)
    if mesh is None:
        return 0.5 * per.mean() / (cfg.nx * cfg.ny) ** 2
    tot = all_reduce_sum(torch.stack([per.sum(), torch.tensor(
        float(per.numel()), dtype=per.dtype, device=per.device)]), mesh, axis)
    return 0.5 * (tot[0] / tot[1]) / (cfg.nx * cfg.ny) ** 2


def ensemble_fd_rollout(step_fn, state0_batch, nt: int,
                        mesh: DeviceMesh | None = None,
                        axis: str = "ensemble", device=None):
    """Run a batch of independent FD rollouts: nt steps of `step_fn` (e.g.
    solvers.chorin_fd.make_step(...)) on every member of `state0_batch`, a
    FlowState whose fields carry a leading member axis (None fields stay
    None). A step whose `batch_polymorphic` attribute is True takes the
    rank's whole share at once, one call a time step; any other step runs
    the members one after another. Either way each member is exactly its
    own single rollout. Returns the final batched FlowState of the share;
    no collective."""
    fields = [f.name for f in dataclasses.fields(state0_batch)]
    batch = {k: getattr(state0_batch, k) for k in fields}
    batch = {k: (None if a is None else _share(a, mesh, axis, device))
             for k, a in batch.items()}
    if getattr(step_fn, "batch_polymorphic", False):
        state = type(state0_batch)(**{
            k: (None if a is None else a.contiguous())
            for k, a in batch.items()})
        for _ in range(nt):
            state = step_fn(state)
        return state
    n = next(a for a in batch.values() if a is not None).shape[0]
    out = {k: (None if a is None else torch.empty_like(a))
           for k, a in batch.items()}
    for m in range(n):
        # each member in tensors of its own (an allocation's alignment, as
        # a single rollout's fields have)
        state = type(state0_batch)(**{
            k: (None if a is None else a[m].clone())
            for k, a in batch.items()})
        for _ in range(nt):
            state = step_fn(state)
        for k in fields:
            if out[k] is not None:
                out[k][m] = getattr(state, k)
    return type(state0_batch)(**out)
