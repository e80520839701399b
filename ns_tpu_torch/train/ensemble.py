"""Ensemble training: N independently drawn surrogates of one family,
trained in lockstep.

Port of `ns_tpu/train/ensemble.py`. The JAX package vmaps one step over a
leading model axis; here a step runs the members one after another, each
with its own objective, gradient and optimizer state, which gives each
member the update the single-model step gives it.

The functional API (`init_ensemble`, `raw_ensemble_step`,
`make_ensemble_train_step`, `train_ensemble`) keeps the JAX signatures
with the port's objects:
  - `model` builds one member from a `generator=` keyword (a model class
    with its arguments bound, e.g. functools.partial(BasisGRU, 2, nx,
    ny)); member m is the m-th draw of one CPU generator seeded with
    `seed`, as EnsembleTrainer draws them;
  - params are {JAX key path: tensor} with a leading model axis;
  - `tx` is what `train/optim.py::Adam` reads (`optim.adam(lr)`, or a
    TrainConfig), and the optimizer state is one `Adam` a member;
  - with a mesh (the port's one-dim 'ensemble' mesh), each rank holds its
    contiguous share of the members and the step makes no collective.

`EnsembleTrainer` serves the families of `ENSEMBLE_MODELS`, 2D and 3D. Its
checkpoint is the JAX one: every params and opt_state leaf carries a
leading model axis (counts (n_models,) int32), as `init_ensemble` and
`jax.vmap(tx.init)` lay it out, and meta holds `n_models`. The JAX rules
stay: no input noise, no minibatch, n_models >= 2, one trajectory for the
basis families. With an 'ensemble' mesh (`ensemble_mesh`, the default
"auto"), each rank trains its contiguous share of the members; the
losses are gathered for the metrics (one all_gather a chunk), and before
a checkpoint every rank gathers the members' params and Adam state (one
all_gather), so the coordinator alone writes the whole model axis, which
the single-device port and ns_tpu resume as before.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.parallel.mesh import make_mesh, member_range, mesh_device
from ns_tpu_torch.train.checkpoint import (jax_key, load_checkpoint,
                                           load_meta, save_checkpoint)
from ns_tpu_torch.train.metrics import l2_loss
from ns_tpu_torch.train.optim import Adam, adam
from ns_tpu_torch.train.trainer import (build_forward, build_model,
                                        check_data, extrapolate_model,
                                        grid_meta, grid_of, load_obs,
                                        training_tensors)

ENSEMBLE_MODELS = ("basis_ode", "basis_ode2", "basis_gru", "basis_ode_conv",
                   "fno", "fno_w", "fno_psi", "fno3d", "fno3d_w",
                   "fno3d_a")


def _map(fn, *trees):
    """fn over the leaves of nested dicts/lists of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return [_map(fn, *z) for z in zip(*trees)]
    return fn(*trees)


# ---------------------------------------------------------------------------
# The functional API
# ---------------------------------------------------------------------------

def _members(model, n_models: int, seed: int) -> list:
    if isinstance(model, nn.Module):
        raise TypeError("pass the model's builder (a class with its "
                        "arguments bound, called with generator=), not a "
                        "built module: each member is drawn anew")
    gen = torch.Generator().manual_seed(seed)
    return [model(generator=gen) for _ in range(n_models)]


def init_ensemble(model, n_models: int, seed: int = 0, device=None) -> dict:
    """Stacked parameters {JAX key path: (n_models, ...)} of n_models
    members drawn from one generator seeded with `seed`, on `device` (the
    card unless "cpu")."""
    dev = resolve_device(device)
    flat = [{jax_key(n): p.detach() for n, p in m.named_parameters()}
            for m in _members(model, n_models, seed)]
    return _map(lambda *x: torch.stack(x).to(dev), *flat)


def init_opt_state(tx, params: dict) -> list:
    """The optimizer state of stacked params (jax.vmap(tx.init)): one
    `Adam` of `tx` a member."""
    n = len(next(iter(params.values())))
    return [Adam(tx, {k: v[m] for k, v in params.items()}) for m in range(n)]


def _architecture(model, device):
    """One built copy of the model on `device` and its (JAX key path,
    parameter) pairs: the members take turns in it."""
    net = _members(model, 1, 0)[0].to(device)
    return net, [(jax_key(n), p) for n, p in net.named_parameters()]


@torch.no_grad()
def _load_member(named, params: dict, m: int) -> None:
    """Copy member m of the stacked params into the built copy."""
    for k, p in named:
        p.copy_(params[k][m])


def raw_ensemble_step(model, tx, obs, nt: int, forward=None):
    """The N-model train step: step(params, opt_state, frames=None) ->
    (params, opt_state, losses (n,)). Each member's tensors are copied
    into one built copy of the model (so a recompute in the backward pass,
    `odeint_checkpoint`'s, sees them too), its loss and gradient taken,
    and its Adam applied to its slice of params in place (params are also
    returned). EnsembleTrainer's iterations are this step.

    forward(model, frames) -> (pred, target) overrides the default
    basis-family objective (the whole trajectory obs (nt, 1, 3, nx, ny)
    from obs[0]); frames=None means the build-time obs."""
    built: dict = {}

    def loss_of(net, frames):
        if forward is not None:
            return l2_loss(*forward(net, frames))
        target = built["obs"]
        return l2_loss(net(target[0], nt), target)

    def step(params, opt_state, frames=None):
        first = next(iter(params.values()))
        if not built:  # the architecture; its values are the members'
            net, named = _architecture(model, first.device)
            built.update(net=net, named=named,
                         obs=torch.as_tensor(obs, device=first.device))
        named = built["named"]
        for k, p in named:
            if p.dtype != params[k].dtype:
                raise ValueError(f"{k}: the model builds {p.dtype}, params "
                                 f"hold {params[k].dtype}")
        losses = []
        for m, opt in enumerate(opt_state):
            _load_member(named, params, m)
            loss = loss_of(built["net"], frames)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        materialize_grads=True)
            opt.params = [params[k][m] for k in opt.names]
            opt.step({k: g for (k, _), g in zip(named, grads)})
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses)

    return step


def make_ensemble_train_step(model, tx, obs, nt: int, mesh=None,
                             axis: str = "ensemble"):
    """(step, shard_tree): obs is shared; params and opt_state carry a
    leading model axis. With a mesh, shard_tree keeps this rank's
    contiguous share of a tree's members (a view: the step's in-place
    updates reach it), and the step runs only those."""
    step = raw_ensemble_step(model, tx, obs, nt)
    if mesh is None:
        return step, lambda tree: tree

    def shard_tree(tree):
        if isinstance(tree, dict):
            lo, hi = member_range(len(next(iter(tree.values()))), mesh, axis)
            return {k: v[lo:hi] for k, v in tree.items()}
        lo, hi = member_range(len(tree), mesh, axis)
        return tree[lo:hi]

    return step, shard_tree


def train_ensemble(model, obs, nt: int, n_models: int, n_iters: int,
                   lr: float = 1e-3, seed: int = 0, mesh=None, device=None):
    """Returns (final params with a leading model axis, the per-model loss
    history (n_iters, n_models)); with a mesh, the rank's share of both.
    Runs on the mesh's device, else `device` (the card unless "cpu")."""
    if mesh is not None:
        device = mesh_device(mesh)
    tx = adam(lr)
    params = init_ensemble(model, n_models, seed, device=device)
    opt_state = init_opt_state(tx, params)
    step, shard_tree = make_ensemble_train_step(model, tx, obs, nt, mesh)
    params = shard_tree(params)
    opt_state = shard_tree(opt_state)
    history = []
    for _ in range(n_iters):
        params, opt_state, losses = step(params, opt_state)
        history.append(losses)
    return params, torch.stack(history)


def ensemble_mesh(n_models: int):
    """The largest usable 'ensemble' mesh: the first k ranks of the
    process group (one device a rank), k the largest count <= the world
    with k | n_models; None if only one device is usable (a world of 1,
    or no process group)."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    k = min(n_models, world)
    while k > 1 and n_models % k:
        k -= 1
    if k <= 1:
        return None
    return make_mesh({"ensemble": k}, devices=range(k))


class EnsembleTrainer:
    """Train `n_models` surrogates of `cfg` on `device` (the card unless
    "cpu"). Member m's parameters are the m-th draw of one CPU generator
    seeded with cfg.seed. `mesh` is an 'ensemble' mesh, None (every member
    on this rank) or "auto" (`ensemble_mesh`); a rank outside the mesh
    holds no member."""

    def __init__(self, cfg, n_models: int, mesh="auto", device=None):
        if cfg.model not in ENSEMBLE_MODELS:
            raise ValueError(f"ensemble training supports {ENSEMBLE_MODELS}, "
                             f"got {cfg.model!r}")
        if cfg.batch_size:
            raise ValueError("batch_size (minibatch sampling) requires "
                             "the single-model Trainer (--n-models 1)")
        if n_models < 2:
            raise ValueError("n_models must be >= 2 for ensemble training")
        if cfg.input_noise:
            raise ValueError(
                "input_noise is not supported for ensemble training (the "
                "vmapped step does not thread per-model noise keys); train "
                "single models with noise, or drop the flag")
        self.cfg, self.n_models = cfg, n_models
        self.device = resolve_device(device)
        obs = load_obs(cfg.npz_path, cfg.n_frames)
        check_data(cfg, obs, operator_only=True)
        self.nt = obs.shape[0]
        self.nx, self.ny, self.nz = grid_of(obs)
        self.builder = functools.partial(build_model, cfg, self.nx, self.ny,
                                         self.nz)
        # {JAX key path: (n_models, ...)}, as init_ensemble stacks them
        self.params = init_ensemble(self.builder, n_models, cfg.seed,
                                    device=self.device)
        self.opts = init_opt_state(cfg, self.params)
        self.obs = torch.as_tensor(obs, device=self.device)
        self.frames, _ = training_tensors(cfg, self.obs)
        self.losses: list = []   # one list of per-model losses an iteration
        self.start_iter = 1
        if cfg.resume:
            self._resume(cfg.resume)
        self.mesh = ensemble_mesh(n_models) if mesh == "auto" else mesh
        self._share = (0, n_models)
        if self.mesh is not None:
            import torch.distributed as dist
            rank = dist.get_rank() if dist.is_initialized() else 0
            self._share = (member_range(n_models, self.mesh)
                           if bool((self.mesh.mesh == rank).any())
                           else (0, 0))
        self._forward = build_forward(cfg, self.frames)
        self._step = raw_ensemble_step(
            self.builder, cfg, self.obs, self.nt,
            forward=lambda net, frames: self._forward(net))

    def _state(self) -> dict:
        """The checkpoint state: every leaf stacked on a leading model axis."""
        return {"params": self.params,
                "opt_state": _map(lambda *x: torch.stack(x),
                                  *(o.state_tree() for o in self.opts))}

    @torch.no_grad()
    def _resume(self, path: str) -> None:
        state = load_checkpoint(path, self._state())
        for k, v in self.params.items():
            v.copy_(torch.as_tensor(state["params"][k]))
        for m, opt in enumerate(self.opts):
            opt.load_state_tree(_map(lambda x: x[m], state["opt_state"]))
        meta = load_meta(path)
        self.losses = [list(map(float, row))
                       for row in meta.get("losses", [])]
        self.start_iter = int(meta.get("iter", 0)) + 1

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """The members' rows of every rank's share (dim 0 of t)."""
        from ns_tpu_torch.parallel.collectives import all_gather
        return all_gather(t, self.mesh, "ensemble", dim=0)

    def train_chunk(self, n: int) -> torch.Tensor:
        """n steps of this rank's members (raw_ensemble_step); the losses
        of every member (n, n_models) stay on the device."""
        lo, hi = self._share
        params = {k: v[lo:hi] for k, v in self.params.items()}
        losses = torch.stack([self._step(params, self.opts[lo:hi])[2]
                              for _ in range(n)])
        if self.mesh is None:
            return losses
        return self._gather(losses.T.contiguous()).T

    @torch.no_grad()
    def _sync_members(self) -> None:
        """Every member's params and Adam state from the rank that trains
        it, in one flat buffer (a no-op without a mesh)."""
        if self.mesh is None:
            return
        lo, hi = self._share
        ref = self.opts[lo]
        leaves = lambda m: ([self.params[k][m] for k in ref.names]  # noqa: E731
                            + list(self.opts[m].mu) + list(self.opts[m].nu))
        sizes = [t.numel() for t in leaves(lo)]
        mine = torch.stack([torch.cat([t.reshape(-1) for t in leaves(m)])
                            for m in range(lo, hi)])
        full = self._gather(mine)
        for m in range(self.n_models):
            for dst, src in zip(leaves(m), full[m].split(sizes)):
                dst.copy_(src.view_as(dst))
            self.opts[m].count = ref.count
            self.opts[m].schedule_count = ref.schedule_count

    def train(self, progress: bool = True) -> list:
        from ns_tpu_torch.parallel.distributed import barrier, is_coordinator
        cfg = self.cfg
        writer = is_coordinator()
        if writer:
            os.makedirs(cfg.out_dir, exist_ok=True)
        it = self.start_iter - 1
        if self._share[0] == self._share[1]:  # a rank outside the mesh
            it = cfg.n_iters
        while it < cfg.n_iters:
            n = min(cfg.ckpt_every - it % cfg.ckpt_every, cfg.n_iters - it)
            rows = self.train_chunk(n).tolist()      # one host read a chunk
            self.losses.extend(rows)
            it += n
            if it % cfg.ckpt_every == 0 or it == cfg.n_iters:
                self._sync_members()
                if writer:
                    self.save(it)
            if progress and writer:
                print(f"[{it}/{cfg.n_iters}] mean loss "
                      f"{np.mean(rows[-1]):.4f}", flush=True)
        if self.mesh is not None:
            barrier("ensemble_done")  # the coordinator's files are written
        return self.losses

    def save(self, it: int) -> str:
        """The checkpoint of every member (after `_sync_members` under a
        mesh), written by the caller's rank."""
        meta = {"iter": it, "losses": self.losses,
                "grid": grid_meta(self.nx, self.ny, self.nz),
                "n_models": self.n_models,
                "config": dataclasses.asdict(self.cfg)}
        return save_checkpoint(self._state(), self.cfg.out_dir, meta=meta)

    def extrapolate(self, npz_path: Optional[str] = None) -> np.ndarray:
        """(n_models, nt, C, *grid): each member's full-horizon rollout
        from frame 0, frame-aligned like Trainer.extrapolate."""
        obs = torch.as_tensor(load_obs(npz_path or self.cfg.npz_path, None),
                              device=self.device)
        net, named = _architecture(self.builder, self.device)
        out = []
        for m in range(self.n_models):
            _load_member(named, self.params, m)
            out.append(extrapolate_model(self.cfg, net, obs))
        return torch.stack(out).cpu().numpy()
