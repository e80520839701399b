"""In-process inference engine: checkpoint directory -> rollouts on the card.

Port of `ns_tpu/serve/engine.py`. The engine rebuilds any trained
surrogate (rnn, the four basis families, fno, fno_w, fno_psi and the 3D
fno3d, fno3d_w, fno3d_a) from a checkpoint alone (its meta JSON carries
the full TrainConfig and the grid), loads the JAX parameter tree into the
torch model (`train/checkpoint.py::params_from_jax`) and serves
`predict(frame0, n_steps)` under `torch.inference_mode()`:

- the operator families roll out autoregressively in chunks of at most
  `chunk` steps, each chunk's frames copied to the host once (the
  recovery of fno_w's (u, v, p) and of fno3d_w's and fno3d_a's (u, v, w,
  p) runs on the card before the copy, in float64), which bounds device
  memory on long replies;
- the basis families discretise t in [0, 1] into the requested horizon
  (models/node.py), so the horizon is the time grid and is not chunked;
- rnn rolls out closed-loop.

The JAX engine pads batches to powers of two and caches one compiled
program per shape to bound XLA compiles; eager torch compiles nothing, so
the port does neither. An ensemble checkpoint (meta `n_models` = M, a
leading M axis on every leaf) is served as M models that start from the
same request state. Entry points run on the card unless given
`device="cpu"`; without a card they raise.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import torch

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.train.checkpoint import load_meta, params_from_jax
from ns_tpu_torch.train.trainer import (FNO_FAMILIES, TrainConfig,
                                        load_obs, rollout_post,
                                        state_of_fields, uvp_of_state)
from ns_tpu_torch.train.trainer import build_model as _build_model


def _checkpoint_path(ckpt: str) -> str:
    return (os.path.join(ckpt, "checkpoint.npz") if os.path.isdir(ckpt)
            else ckpt)


def _params_of(ckpt: str) -> dict:
    """The params/... leaves of a checkpoint as {JAX key path: array}; the
    opt_state/... leaves are not read."""
    with np.load(ckpt) as data:
        return {k[len("params/"):]: data[k] for k in data.files
                if k.startswith("params/")}


def load_checkpoint_params(ckpt: str,
                           model: torch.nn.Module) -> torch.nn.Module:
    """Fill `model` from the params subtree of a Trainer checkpoint (the
    serving engine carries no optimizer state): leaf by leaf by key path,
    with shape checks and an error naming every missing leaf."""
    ckpt = _checkpoint_path(ckpt)
    return params_from_jax(model, _params_of(ckpt), what=f"checkpoint {ckpt}")


class ServingBase:
    """Thread-safe request and latency stats shared by the serving
    engines."""

    def _init_serving(self):
        self._stats_lock = threading.Lock()
        self._latencies: list[float] = []
        self._requests = 0
        self._steps_served = 0

    def _record(self, dt: float, n_steps: int) -> None:
        with self._stats_lock:
            self._requests += 1
            self._steps_served += n_steps
            self._latencies.append(dt)
            if len(self._latencies) > 4096:
                del self._latencies[:2048]

    def _stats_base(self) -> dict:
        """The JAX engine's keys; `compiled_programs` is 0, since eager
        torch compiles no program."""
        with self._stats_lock:
            lat = sorted(self._latencies)
            n = len(lat)
            pct = (lambda q: lat[min(n - 1, int(q * n))]) if n else (
                lambda q: None)
            return {
                "grid": [self.nx, self.ny],
                "chunk": self.chunk,
                "requests": self._requests,
                "steps_served": self._steps_served,
                "compiled_programs": 0,
                "latency_s": {"p50": pct(0.50), "p90": pct(0.90),
                              "p99": pct(0.99),
                              "max": lat[-1] if n else None},
            }


class InferenceEngine(ServingBase):
    """Serve full-state extrapolation from a trained surrogate.

    predict(frame0, n_steps) -> frames (numpy float32):
      frame0  (3, nx, ny) or (B, 3, nx, ny) (u, v, p); for the 3D families
              (4, nx, ny, nz) or (B, 4, nx, ny, nz) (u, v, w, p)
      frames  (n_steps + 1,) + frame0's state shape, B leading if batched;
              frames[..., 0, :, ...] is the input frame (for fno_w, fno3d_w
              and fno3d_a its fields recovered from the model's
              representation), so frames[t] approximates the state t
              surrogate frames later. For an ensemble (M models) a leading
              member axis is prepended.

    `models` holds one module per ensemble member, parameters loaded, on
    `device`; `nz` is the 3D families' third grid side.
    """

    def __init__(self, cfg: TrainConfig, models, nx: int, ny: int,
                 chunk: int = 64, device=None, nz: int | None = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.cfg, self.nx, self.ny, self.chunk = cfg, nx, ny, chunk
        self.nz = nz
        self.device = resolve_device(device)
        self.models = [m.to(self.device).eval() for m in models]
        self.n_models = len(self.models)
        self._post = (rollout_post(cfg) if cfg.model in FNO_FAMILIES
                      else None)
        self._init_serving()

    # -- construction -------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, ckpt: str, chunk: int = 64,
                        device=None) -> "InferenceEngine":
        """ckpt: a checkpoint.npz path or a directory holding one."""
        device = resolve_device(device)
        ckpt = _checkpoint_path(ckpt)
        meta = load_meta(ckpt)
        if "config" not in meta:
            raise ValueError(f"{ckpt} has no embedded config; pass a "
                             "checkpoint written by train.trainer.Trainer")
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        cfg = TrainConfig(**{k: v for k, v in meta["config"].items()
                             if k in fields})
        if "grid" in meta:
            grid = [int(v) for v in meta["grid"]]     # [nx, ny(, nz)]
        else:  # a checkpoint from before the grid was recorded: its data
            grid = list(load_obs(cfg.npz_path, 1).shape[3:])
        nx, ny = grid[0], grid[1]
        nz = grid[2] if len(grid) == 3 else None
        n_models = int(meta.get("n_models", 1))
        flat = _params_of(ckpt)
        models = []
        for m in range(n_models):
            model = _build_model(cfg, nx, ny, nz, device="meta")
            model = model.to_empty(device=device)
            member = flat if n_models == 1 else {k: v[m]
                                                 for k, v in flat.items()}
            models.append(params_from_jax(model, member,
                                          what=f"checkpoint {ckpt}"))
        return cls(cfg, models, nx, ny, chunk=chunk, device=device, nz=nz)

    # -- rollouts -------------------------------------------------------------

    def _rollout_fno(self, model, x: torch.Tensor, n_steps: int,
                     out: torch.Tensor) -> None:
        """Fill out (n_steps + 1, B) + the state shape on the host: frame 0
        is the request state echoed in the data's fields, then one host copy
        a chunk of at most `chunk` steps."""
        out[0].copy_(uvp_of_state(self.cfg, x))
        state, done = x, 0
        while done < n_steps:
            length = min(self.chunk, n_steps - done)
            xs = model.rollout(state, length, post=self._post)
            out[done + 1:done + 1 + length].copy_(
                uvp_of_state(self.cfg, xs))
            state = xs[-1]
            done += length

    def _run(self, x: torch.Tensor, n_steps: int, out: torch.Tensor) -> None:
        """x (B,) + the state shape on the device; fill out (M, n_steps + 1,
        B) + the state shape on the host."""
        if self.cfg.model in FNO_FAMILIES:
            x = state_of_fields(self.cfg, x)
        for model, out_m in zip(self.models, out):
            if self.cfg.model in FNO_FAMILIES:
                self._rollout_fno(model, x, n_steps, out_m)
            elif self.cfg.model == "rnn":
                b = x.shape[0]
                pred = model.extrapolate(x.reshape(b, -1), n_steps)
                out_m[0].copy_(x)
                out_m[1:].copy_(pred.transpose(0, 1).reshape(
                    n_steps, b, 3, self.nx, self.ny))
            else:  # the horizon is the solve's time grid, t = 0 included
                out_m.copy_(model(x, n_steps + 1))

    # -- public API ---------------------------------------------------------

    def _state_shape(self) -> tuple:
        return ((4, self.nx, self.ny, self.nz) if self.nz
                else (3, self.nx, self.ny))

    def predict(self, frame0: np.ndarray, n_steps: int) -> np.ndarray:
        frame0 = np.asarray(frame0, dtype=np.float32)
        state_shape = self._state_shape()
        r = len(state_shape)
        if (frame0.ndim not in (r, r + 1)
                or frame0.shape[-r:] != state_shape):
            raise ValueError(
                f"frame0 must be {state_shape} or (B,) + {state_shape}; "
                f"got {frame0.shape}")
        if n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        batched = frame0.ndim == r + 1
        x = frame0 if batched else frame0[None]
        t0 = time.perf_counter()
        seq = np.empty((self.n_models, n_steps + 1) + x.shape, np.float32)
        with torch.inference_mode():
            self._run(torch.tensor(x, device=self.device), n_steps,
                      torch.from_numpy(seq))
        # (M, n_steps + 1, B, ...) -> (M, B, n_steps + 1, ...)
        out = np.moveaxis(seq, 1, 2)
        if not batched:
            out = out[:, 0]
        if self.n_models == 1:
            out = out[0]
        self._record(time.perf_counter() - t0, n_steps * x.shape[0])
        return out

    def warmup(self, n_steps: int = 1, batch: int = 1) -> None:
        """Run one request of the given shape (cuBLAS and cuFFT plans, the
        cached tables) before the first timed one."""
        shape = self._state_shape()
        if batch > 1:
            shape = (batch,) + shape
        self.predict(np.zeros(shape, np.float32), n_steps)

    def stats(self) -> dict:
        return {"model": self.cfg.model, **self._stats_base()}
