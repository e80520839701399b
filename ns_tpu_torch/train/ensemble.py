"""Ensemble training: N independently drawn surrogates of one family,
trained in lockstep.

Port of `ns_tpu/train/ensemble.py` (`EnsembleTrainer`) for the families of
`ENSEMBLE_MODELS`, 2D and 3D. The JAX package vmaps one step over a leading model
axis; here a step runs the members one after another, each with its own
objective, gradient and optimizer state, which gives each member the
update the single-model step gives it. The checkpoint is the JAX one:
every params and opt_state leaf carries a leading model axis (counts
(n_models,) int32), as `init_ensemble` and `jax.vmap(tx.init)` lay it out,
and meta holds `n_models`. The JAX rules stay: no input noise, no
minibatch, n_models >= 2, one trajectory for the basis families. There is
one card, so the mesh argument is accepted and every member runs on
`device`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.train.checkpoint import (jax_key, load_checkpoint,
                                           load_meta, params_from_jax,
                                           save_checkpoint)
from ns_tpu_torch.train.metrics import l2_loss
from ns_tpu_torch.train.optim import Adam
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


class EnsembleTrainer:
    """Train `n_models` surrogates of `cfg` on `device` (the card unless
    "cpu"). Member m's parameters are the m-th draw of one CPU generator
    seeded with cfg.seed."""

    def __init__(self, cfg, n_models: int, mesh="auto", device=None):
        del mesh  # one card: every member runs on `device`
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
        gen = torch.Generator().manual_seed(cfg.seed)
        self.models = [build_model(cfg, self.nx, self.ny, self.nz,
                                   generator=gen).to(self.device)
                       for _ in range(n_models)]
        self.obs = torch.as_tensor(obs, device=self.device)
        self.frames, _ = training_tensors(cfg, self.obs)
        self.params = [{jax_key(n): p for n, p in m.named_parameters()}
                       for m in self.models]
        self.opts = [Adam(cfg, p) for p in self.params]
        self.losses: list = []   # one list of per-model losses an iteration
        self.start_iter = 1
        if cfg.resume:
            self._resume(cfg.resume)
        self._forward = build_forward(cfg, self.frames)

    def _state(self) -> dict:
        """The checkpoint state: every leaf stacked on a leading model axis."""
        return {"params": _map(lambda *x: torch.stack(x), *self.params),
                "opt_state": _map(lambda *x: torch.stack(x),
                                  *(o.state_tree() for o in self.opts))}

    def _resume(self, path: str) -> None:
        state = load_checkpoint(path, self._state())
        for m, (model, opt) in enumerate(zip(self.models, self.opts)):
            member = _map(lambda x: x[m], state)
            params_from_jax(model, member["params"],
                            what=f"checkpoint {path}")
            opt.load_state_tree(member["opt_state"])
        meta = load_meta(path)
        self.losses = [list(map(float, row))
                       for row in meta.get("losses", [])]
        self.start_iter = int(meta.get("iter", 0)) + 1

    def train_chunk(self, n: int) -> torch.Tensor:
        """n steps of every member; the losses (n, n_models) stay on the
        device."""
        rows = []
        for _ in range(n):
            row = []
            for model, params, opt in zip(self.models, self.params,
                                          self.opts):
                loss = l2_loss(*self._forward(model))
                grads = torch.autograd.grad(loss, list(params.values()),
                                            materialize_grads=True)
                opt.step(dict(zip(params, grads)))
                row.append(loss.detach())
            rows.append(torch.stack(row))
        return torch.stack(rows)

    def train(self, progress: bool = True) -> list:
        cfg = self.cfg
        os.makedirs(cfg.out_dir, exist_ok=True)
        it = self.start_iter - 1
        while it < cfg.n_iters:
            n = min(cfg.ckpt_every - it % cfg.ckpt_every, cfg.n_iters - it)
            rows = self.train_chunk(n).tolist()      # one host read a chunk
            self.losses.extend(rows)
            it += n
            if it % cfg.ckpt_every == 0 or it == cfg.n_iters:
                self.save(it)
            if progress:
                print(f"[{it}/{cfg.n_iters}] mean loss "
                      f"{np.mean(rows[-1]):.4f}", flush=True)
        return self.losses

    def save(self, it: int) -> str:
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
        return torch.stack([extrapolate_model(self.cfg, m, obs)
                            for m in self.models]).cpu().numpy()
