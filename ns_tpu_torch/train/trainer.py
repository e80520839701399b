"""One trainer for the surrogate families, and the configuration that
training, evaluation and serving share.

Port of `ns_tpu/train/trainer.py`: `TrainConfig` with every field, default
and check of the JAX package's (a checkpoint's `meta["config"]` rebuilds it
field by field), the observation loader, `rollout_post` (the per-step
constraint map of the operator families' rollouts), `build_model` (where
training and serving build their models), `build_forward` (the per-family
objective) and `Trainer`, the reference's training protocol:

  - data: the npz rollout's first `n_frames` frames as (nt, M, 3, nx, ny),
    or (nt, M, 4, nx, ny, nz) for 3D (u, v, w, p) rollouts;
  - Adam at lr 1e-3 by default (`train/optim.py`, optax's arithmetic, with
    the optional schedule and clip), loss = the global L2 norm of the
    residual; the basis families' diversity penalty is logged, not
    optimised;
  - a checkpoint and a JSONL line every `ckpt_every` iterations, in the JAX
    package's format (each package resumes the other's checkpoints), and a
    full-horizon extrapolation at the end.

Data-parallel training (`TrainConfig.dp`): a device is a rank, so dp is
the size of a {'data': dp} mesh over the process group (`make_dp_mesh`;
dp must equal the world size). The operator families shard the
training-window batch and rnn its trajectories, each rank taking a
contiguous share (shares differ by one where the batch does not divide);
params and Adam state are replicated. The loss is the global L2 norm: each
rank's sum of squares is all-reduced in the forward pass (the backward
passes the gradient through), and the parameter gradients are summed once
over the ranks in one flat buffer, so every rank applies the same update.
Every rank draws the whole batch's windows and noise from its generator
and keeps its share, so the generator state, and resume, do not depend on
dp. Only the coordinator writes the checkpoint and the metrics.

Steps run in chunks of up to `ckpt_every` iterations whose losses stay on
the device: a chunk reads nothing back to the host, and `train` reads the
chunk's losses (and the penalty) once. Every entry point runs on the card
unless given `device="cpu"`; without a card it raises.

Random streams: the parameters are drawn on the CPU from
`torch.Generator().manual_seed(cfg.seed)` with the JAX init's
distributions, then moved to the device, so card and CPU runs start from
the same bits (JAX's threefry draws cannot be reproduced). The input noise
and the minibatch windows come from a generator on the device; its state
is saved in the checkpoint's meta under `torch_generator`, and `noise_key`
is written as null, so the JAX Trainer re-derives its own stream from the
seed when it resumes. A JAX checkpoint's `noise_key` seeds the port's
generator from its two words.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.train.checkpoint import (jax_key, load_checkpoint,
                                           load_meta, params_from_jax,
                                           save_checkpoint)
from ns_tpu_torch.train.metrics import AverageMeter, l2_loss
from ns_tpu_torch.train.optim import Adam

MODELS = ("basis_ode", "basis_ode2", "basis_gru", "basis_ode_conv",
          "rnn", "fno", "fno_w", "fno_psi", "fno3d", "fno3d_w",
          "fno3d_a")

# the operator families: next-step maps whose training objective batches
# trajectories and supports pushforward/noise
FNO_FAMILIES = ("fno", "fno_w", "fno_psi", "fno3d", "fno3d_w",
                "fno3d_a")

# the vorticity-representation members: trained on the curl of the
# velocity data, the full field recovered at evaluation, so every
# prediction is exactly divergence-free
W_FAMILIES = ("fno_w", "fno3d_w", "fno3d_a")

# the data-parallel mesh axis
DATA_AXIS = "data"


@dataclasses.dataclass
class TrainConfig:
    """The reference training script's parameters (spectral_ode.py:141-150)
    plus the model selection and the operator families' knobs."""

    model: str = "basis_ode"
    npz_path: str = "./data_semi_implicit.npz"
    out_dir: str = "./checkpoints/basis_ode"
    n_iters: int = 1000
    n_coeffs: int = 10
    lr: float = 1e-3
    hidden_dim: int = 512  # rnn baseline hidden size (ref rnn.py:89)
    n_frames: int = 100
    ckpt_every: int = 10
    seed: int = 0
    resume: Optional[str] = None  # path to checkpoint.npz
    # fno families: train on k-step autoregressive rollouts (the
    # pushforward trick) instead of single next-step prediction
    fno_rollout_steps: int = 1
    # fno capacity: spectral modes kept per axis and channel width
    fno_modes: int = 12
    fno_width: int = 32
    # fno (uvp) only: the exact spectral divergence projection composed
    # into the autoregressive rollout
    fno_project: bool = False
    # fno/fno_w: train-time Gaussian noise on the input frames (std =
    # input_noise * std(data)); 0 disables
    input_noise: float = 0.0
    # fno/fno_w: rematerialize each unroll step of the k-step objective
    fno_remat: bool = False
    # fno_w/fno_psi/fno3d: dealias-filter each fed-back prediction onto
    # the 2/3 band the training data lives on
    fno_dealias: bool = True
    # the FNO layers' spectral engine: 'matmul' (truncated DFT products),
    # 'fft', or 'auto' by grid size (models/fno.py::_MATMUL_MAX_SIDE);
    # checkpoints transfer between engines
    fno_transform: str = "auto"
    # the FNO layers' GEMM precision: None (fp32 with TF32 off on the
    # card; the TPU ran a bf16-class pass), 'default', 'high', 'highest'
    fno_precision: Optional[str] = None
    # fno families: sample batch_size training windows with replacement
    # every step (0 keeps the full-batch objective)
    batch_size: int = 0
    # 'constant' (the reference's fixed Adam lr) or 'cosine', either with
    # an optional linear warm-up; progress rides the optimizer state
    lr_schedule: str = "constant"
    warmup_iters: int = 0
    # total iterations the schedule decays over (None = this run's n_iters)
    schedule_horizon: Optional[int] = None
    # global-norm gradient clipping (0 disables)
    grad_clip: float = 0.0
    # data-parallel training over dp devices (1 = single device)
    dp: int = 1

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got {self.model!r}")
        if self.fno_transform not in ("auto", "fft", "matmul"):
            raise ValueError(f"fno_transform must be auto|fft|matmul, "
                             f"got {self.fno_transform!r}")
        if self.fno_precision not in (None, "default", "high", "highest"):
            raise ValueError(f"fno_precision must be None|default|high|"
                             f"highest, got {self.fno_precision!r}")
        if self.n_iters < 0:
            raise ValueError(f"n_iters must be >= 0, got {self.n_iters}")
        if self.ckpt_every < 1:
            raise ValueError(
                f"ckpt_every must be >= 1, got {self.ckpt_every}")
        if self.dp < 1:
            raise ValueError(f"dp must be >= 1, got {self.dp}")
        if self.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"lr_schedule must be constant|cosine, "
                             f"got {self.lr_schedule!r}")
        if self.warmup_iters < 0:
            raise ValueError(
                f"warmup_iters must be >= 0, got {self.warmup_iters}")
        if self.schedule_horizon is not None and self.schedule_horizon < 1:
            raise ValueError(f"schedule_horizon must be >= 1, "
                             f"got {self.schedule_horizon}")
        if self.grad_clip < 0:
            raise ValueError(
                f"grad_clip must be >= 0 (0 disables), got {self.grad_clip}")
        if self.batch_size < 0:
            raise ValueError(f"batch_size must be >= 0 (0 = full batch), "
                             f"got {self.batch_size}")
        if self.batch_size > 0 and self.model not in FNO_FAMILIES:
            raise ValueError(
                f"batch_size samples next-step training windows, which "
                f"only the operator families (fno/fno_w/fno3d) have; "
                f"{self.model!r} trains on the whole trajectory")
        if self.model == "fno3d_w":
            warnings.warn(
                "fno3d_w (raw 3-component vorticity representation) "
                "reproducibly diverges to inf on this repo's own 3D "
                "benchmarks at every tried capacity/noise setting "
                "(RESULTS.md '3D surrogate quality' table). Use "
                "fno3d_a (vector-potential representation, exactly "
                "divergence-free) or fno3d (raw uvwp) instead.",
                stacklevel=2)


def load_obs(npz_path: str, n_frames: Optional[int]) -> np.ndarray:
    """npz rollout -> obs (nt, M, C, *spatial) float32 numpy: 2D rollouts
    (u, v, p) -> (nt, M, 3, nx, ny), 3D rollouts (a w key) -> (nt, M, 4,
    nx, ny, nz); M > 1 for multi-trajectory datasets, whose trajectory axis
    leads in the file."""
    with np.load(npz_path) as data:
        names = ("u", "v", "w", "p") if "w" in data else ("u", "v", "p")
        fields = [data[k] for k in names]
    multi = fields[0].ndim == (5 if len(names) == 4 else 4)
    if n_frames is not None:
        fields = [f[:, :n_frames] if multi else f[:n_frames] for f in fields]
    if multi:
        return np.swapaxes(np.stack(fields, axis=2).astype(np.float32), 0, 1)
    return np.stack(fields, axis=1).astype(np.float32)[:, None]


def rollout_post(cfg):
    """The per-step constraint map composed into the operator families'
    autoregression, or None: the 2/3-band dealias for fno_w and fno_psi
    (for fno_psi channelwise: a spectral mask commutes with the spectral
    derivatives, so the solenoidal property holds), the exact divergence
    projection for fno with fno_project; in 3D the dealias and/or Leray
    filter of every fno3d step (one spectral round trip) and the band
    filter of fno3d_w's and fno3d_a's (their recovery makes them
    divergence-free). One definition for training feedback, evaluation
    and serving."""
    if cfg.model in ("fno_w", "fno_psi") and cfg.fno_dealias:
        from ns_tpu_torch.models.vorticity import dealias_field
        return lambda x: dealias_field(x)
    if cfg.model == "fno" and getattr(cfg, "fno_project", False):
        from ns_tpu_torch.models.projection import project_periodic

        def post(x):
            u_p, v_p = project_periodic(x[..., 0, :, :], x[..., 1, :, :])
            return torch.stack([u_p, v_p, x[..., 2, :, :]], dim=-3)

        return post
    if cfg.model == "fno3d" and (getattr(cfg, "fno_project", False)
                                 or cfg.fno_dealias):
        from functools import partial

        from ns_tpu_torch.models.projection import rollout_filter3d
        return partial(rollout_filter3d,
                       project=getattr(cfg, "fno_project", False),
                       dealias=cfg.fno_dealias)
    if cfg.model in ("fno3d_w", "fno3d_a") and cfg.fno_dealias:
        from ns_tpu_torch.models.vorticity3d import dealias_field3d
        return dealias_field3d
    return None


_3D = ("fno3d", "fno3d_w", "fno3d_a")


def build_model(cfg: TrainConfig, nx: int, ny: int, nz: int | None = None,
                device=None, dtype=None, generator=None):
    """The model of `cfg` on an (nx, ny) grid, or (nx, ny, nz) for the 3D
    families, as the JAX package's Trainer builds it, with parameters on
    `device` (the meta device builds no values), drawn from `generator`."""
    kw = dict(device=device, dtype=dtype, generator=generator)
    if cfg.model == "basis_ode":
        from ns_tpu_torch.models.basis import BasisODE
        return BasisODE(cfg.n_coeffs, nx, ny, **kw)
    if cfg.model == "basis_ode2":
        from ns_tpu_torch.models.basis import BasisODE2
        return BasisODE2(cfg.n_coeffs, nx, ny, **kw)
    if cfg.model == "basis_gru":
        from ns_tpu_torch.models.basis import BasisGRU
        return BasisGRU(cfg.n_coeffs, nx, ny, **kw)
    if cfg.model == "basis_ode_conv":
        from ns_tpu_torch.models.basis import BasisODEConv
        return BasisODEConv(cfg.n_coeffs, nx, ny, **kw)
    if cfg.model in ("fno", "fno_w"):
        from ns_tpu_torch.models.fno import FNO2D
        return FNO2D(nx, ny, width=cfg.fno_width, modes=cfg.fno_modes,
                     channels=1 if cfg.model == "fno_w" else 3,
                     transform=cfg.fno_transform,
                     precision=cfg.fno_precision, **kw)
    if cfg.model == "fno_psi":
        from ns_tpu_torch.models.streamfunction import FNOPsi
        return FNOPsi(nx, ny, width=cfg.fno_width, modes=cfg.fno_modes,
                      transform=cfg.fno_transform,
                      precision=cfg.fno_precision, **kw)
    if cfg.model in _3D:
        from ns_tpu_torch.models.fno3d import FNO3D
        return FNO3D(nx, ny, nz, width=cfg.fno_width, modes=cfg.fno_modes,
                     channels=4 if cfg.model == "fno3d" else 3,
                     transform=cfg.fno_transform,
                     precision=cfg.fno_precision, **kw)
    if cfg.model == "rnn":
        from ns_tpu_torch.models.gru import FullFieldGRU
        return FullFieldGRU(3 * nx * ny, cfg.hidden_dim, **kw)
    raise ValueError(f"unknown model family {cfg.model!r}")


def uvp_of_state(cfg: TrainConfig, state: torch.Tensor) -> torch.Tensor:
    """A model state (..., C, *grid) as the data's fields: fno_w's vorticity
    as (u, v, p) (..., 3, nx, ny), fno3d_w's vorticity and fno3d_a's vector
    potential as (u, v, w, p) (..., 4, nx, ny, nz), each recovered in
    float64 and rounded once to the state's dtype (in float32 fno_w's
    recovery's own FFT rounding left 1.1e-5 of max|u| of divergence on the
    H100); every other family's state as it is. The one definition of
    serving and `extrapolate`."""
    if cfg.model == "fno_w":
        from ns_tpu_torch.models.vorticity import uvp_from_w
        uvp = uvp_from_w(state[..., 0, :, :].to(torch.float64))
        return torch.stack(uvp, dim=-3).to(state.dtype)
    if cfg.model in W_FAMILIES:
        from ns_tpu_torch.models.vorticity3d import repr3d_fns
        return repr3d_fns(cfg.model)[1](
            state.to(torch.float64)).to(state.dtype)
    return state


def state_of_fields(cfg: TrainConfig, x: torch.Tensor) -> torch.Tensor:
    """Data fields (..., C, *grid) as the model's state: fno_w's vorticity
    (..., 1, nx, ny), fno3d_w's and fno3d_a's representation of (u, v, w)
    (..., 3, nx, ny, nz), in the fields' dtype; every other family's
    fields as they are."""
    if cfg.model == "fno_w":
        from ns_tpu_torch.models.vorticity import vorticity_from_uv
        return vorticity_from_uv(x[..., 0, :, :], x[..., 1, :, :]).unsqueeze(-3)
    if cfg.model in W_FAMILIES:
        from ns_tpu_torch.models.vorticity3d import repr3d_fns
        return repr3d_fns(cfg.model)[0](x[..., :3, :, :, :])
    return x


def batch_share(n: int, index: int, size: int) -> tuple[int, int]:
    """[lo, hi) of a batch of n that rank `index` of `size` takes: the
    contiguous shares of np.array_split, sizes differing by one."""
    q, r = divmod(n, size)
    lo = index * q + min(index, r)
    return lo, lo + q + (index < r)


def build_forward(cfg: TrainConfig, frames: torch.Tensor,
                  data_scale: float = 1.0, share=None):
    """forward(model, gen=None) -> (pred, target): the per-family training
    objective, shared by Trainer and EnsembleTrainer.

    frames is the training tensor of `training_tensors`, (nt, M, C, *grid)
    with M trajectories sharing the operator; data_scale the std that
    cfg.input_noise is a fraction of. `gen` (a torch.Generator on the
    frames' device) draws the minibatch windows, then the input noise;
    None draws neither (the ensemble's objective).
      - rnn: teacher-forced next-frame prediction, trajectories on the
        GRU's batch axis;
      - the FNO families: the next-step map on every window (or a sample of
        batch_size windows with replacement), k = fno_rollout_steps steps
        from each start with every prediction fed back through
        `rollout_post` (the loss is on the raw predictions), noise on the
        first input only, each step rematerialised in the backward pass
        when fno_remat;
      - the basis families: the whole trajectory from frame 0.
    share=(index, size) keeps rank `index`'s share of the batch axis
    (`batch_share`): rnn's trajectories, the FNO families' windows; the
    windows and the noise are drawn for the whole batch first.
    """
    nt = frames.shape[0]

    def mine(t):
        if share is None:
            return t
        return t[slice(*batch_share(t.shape[0], *share))]

    def forward(model, gen=None):
        if cfg.model == "rnn":
            m = frames.shape[1]
            seq = mine(frames.transpose(0, 1).reshape(m, nt, -1))
            return model(seq[:, :-1]), seq[:, 1:]
        if cfg.model not in FNO_FAMILIES:
            return model(frames[0], nt), frames
        k = max(cfg.fno_rollout_steps, 1)
        n_win = nt - k
        idx = None
        if cfg.batch_size > 0 and gen is not None:
            idx = torch.randint(0, n_win, (cfg.batch_size,), generator=gen,
                                device=frames.device)

        def window(j):
            if idx is None:
                return mine(frames[j:n_win + j])
            return torch.index_select(frames, 0, mine(idx) + j)

        x = window(0)
        if cfg.input_noise > 0 and gen is not None:
            shape = (n_win if idx is None else len(idx), *x.shape[1:])
            x = x + cfg.input_noise * data_scale * mine(torch.randn(
                shape, generator=gen, device=x.device, dtype=x.dtype))
        if k == 1:
            return model(x), window(1)
        if cfg.fno_remat:
            from torch.utils.checkpoint import checkpoint
            apply = lambda t: checkpoint(model, t, use_reentrant=False,  # noqa: E731
                                         preserve_rng_state=False)
        else:
            apply = model
        post = rollout_post(cfg)
        preds, targets = [], []
        for j in range(1, k + 1):
            pred = apply(x)
            preds.append(pred)
            targets.append(window(j))
            x = post(pred) if post is not None else pred
        return torch.stack(preds), torch.stack(targets)

    return forward


@torch.no_grad()
def extrapolate_model(cfg: TrainConfig, model, obs_full: torch.Tensor
                      ) -> torch.Tensor:
    """The full-horizon closed-loop rollout (nt, C, *grid) from frame 0 of
    trajectory 0 of obs_full (nt, M, C, *grid), frame-aligned (out[t] ~
    obs[t]) except rnn, which keeps the reference's nt predictions from
    obs[0] (out[t] ~ obs[t + 1])."""
    nt = obs_full.shape[0]
    if cfg.model in FNO_FAMILIES:
        x0 = state_of_fields(cfg, obs_full[0, 0])
        seq = model.rollout(x0, nt - 1, post=rollout_post(cfg))
        return uvp_of_state(cfg, torch.cat([x0[None], seq]))
    if cfg.model == "rnn":
        pred = model.extrapolate(obs_full[0, :1].reshape(1, -1), nt)
        return pred[0].reshape(nt, *obs_full.shape[2:])
    return model(obs_full[0], nt)[:, 0]


def grid_of(obs) -> tuple:
    """(nx, ny, nz) of observations (nt, M, C, *grid); nz None for 2D."""
    nx, ny, *nz = obs.shape[3:]
    return nx, ny, (nz[0] if nz else None)


def grid_meta(nx: int, ny: int, nz: int | None) -> list:
    """The checkpoint meta's `grid`: [nx, ny] or [nx, ny, nz]."""
    return [nx, ny] if nz is None else [nx, ny, nz]


def _noise_seed(seed: int) -> int:
    """The input-noise generator's seed: its own stream beside the init's
    (JAX folds 0x6E5E into the init key)."""
    return ((seed & 0xFFFFFFFF) << 16) | 0x6E5E


def check_data(cfg: TrainConfig, obs: np.ndarray, operator_only=False):
    """The JAX trainers' checks of the data against the family: 2D data for
    a 2D family, one trajectory for the basis families (rnn too when
    `operator_only`), a fno_rollout_steps that leaves training windows."""
    nt, n_traj, spatial = obs.shape[0], obs.shape[1], obs.shape[3:]
    wants_3d = cfg.model in _3D
    if (len(spatial) == 3) != wants_3d:
        raise ValueError(
            f"{cfg.model!r} expects "
            f"{'3D (u,v,w,p)' if wants_3d else '2D (u,v,p)'}"
            f" data; {cfg.npz_path} has spatial shape {spatial}")
    multi = FNO_FAMILIES if operator_only else FNO_FAMILIES + ("rnn",)
    if n_traj > 1 and cfg.model not in multi:
        raise ValueError(
            f"multi-trajectory data (M={n_traj}) needs an operator "
            f"family {multi}; {cfg.model!r} learns a single coefficient "
            "trajectory by design (reference semantics)")
    if cfg.model in FNO_FAMILIES and not 1 <= cfg.fno_rollout_steps < nt:
        raise ValueError(
            f"fno_rollout_steps must be in [1, n_frames={nt}); got "
            f"{cfg.fno_rollout_steps} (a k >= n_frames leaves no training "
            "windows and the loss is identically 0)")


def training_tensors(cfg: TrainConfig, obs: torch.Tensor):
    """(frames, data_scale): the tensor the objective trains on (fno_w: the
    vorticity of the data, (nt, M, 1, nx, ny); fno3d_w and fno3d_a: the
    vorticity or vector potential, (nt, M, 3, nx, ny, nz); obs otherwise)
    and the std (ddof 0, as jnp.std) that input_noise is a fraction of."""
    frames = state_of_fields(cfg, obs)
    scale = 1.0
    if cfg.model in FNO_FAMILIES:
        scale = float(torch.std(frames, correction=0))
    return frames, scale


def make_dp_mesh(cfg: TrainConfig):
    """The {'data': dp} mesh of data-parallel training over every rank of
    the process group (one device a rank): dp must equal the world size,
    and dp > 1 needs a process group. None for a family without a batch
    axis at dp 1. The JAX package's errors: such a family at dp > 1, and
    more devices than there are."""
    import torch.distributed as dist

    from ns_tpu_torch.parallel.mesh import make_mesh
    if cfg.model not in FNO_FAMILIES + ("rnn",):
        if cfg.dp == 1:
            return None
        raise ValueError(
            f"dp={cfg.dp} needs a batched objective (fno/fno_w/fno3d "
            f"shard training windows, rnn shards trajectories); "
            f"{cfg.model!r} learns one coefficient trajectory with no "
            "batch axis (reference semantics)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if cfg.dp > world:
        raise ValueError(f"dp={cfg.dp} > {world} available devices (the "
                         "port runs one device a rank: launch dp ranks "
                         "with python -m ns_tpu_torch.launch)")
    if cfg.dp < world:
        raise ValueError(f"dp={cfg.dp} < {world} devices of the process "
                         "group: the data mesh spans every rank")
    return make_mesh({DATA_AXIS: cfg.dp})


class _SumOverRanks(torch.autograd.Function):
    """The all-reduced sum of a rank's partial sum; the backward passes
    the gradient through, so each rank's parameter gradient is its share
    of the global one (summed once, in `Trainer._sync`)."""

    @staticmethod
    def forward(ctx, t, mesh):
        from ns_tpu_torch.parallel.collectives import all_reduce_sum
        return all_reduce_sum(t, mesh, DATA_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Trainer:
    """Train one surrogate of `cfg` on `device` (the card unless "cpu").
    `mesh` (default: `make_dp_mesh` when cfg.dp > 1) is the {'data': dp}
    mesh of data-parallel training; cli.train --dist passes it at dp 1
    too, so a world of one rank runs the same collectives."""

    def __init__(self, cfg: TrainConfig, device=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        obs = load_obs(cfg.npz_path, cfg.n_frames)
        check_data(cfg, obs)
        self.nt = obs.shape[0]
        self.nx, self.ny, self.nz = grid_of(obs)
        if cfg.model in FNO_FAMILIES and cfg.input_noise < 0:
            raise ValueError(
                f"input_noise must be >= 0; got {cfg.input_noise}")
        if mesh is None and cfg.dp > 1:
            mesh = make_dp_mesh(cfg)
        self.mesh = mesh
        share = None
        if mesh is not None:
            from ns_tpu_torch.parallel.mesh import axis_index, axis_size
            share = (axis_index(mesh, DATA_AXIS),
                     axis_size(mesh, DATA_AXIS))
            if share[1] != cfg.dp:
                raise ValueError(f"dp={cfg.dp}, but the mesh's "
                                 f"{DATA_AXIS!r} axis has {share[1]} ranks")
        self.model = build_model(
            cfg, self.nx, self.ny, self.nz,
            generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.obs = torch.as_tensor(obs, device=self.device)
        self.frames, self._data_scale = training_tensors(cfg, self.obs)
        self.params = {jax_key(n): p for n, p in self.model.named_parameters()}
        self.opt = Adam(cfg, self.params)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(_noise_seed(cfg.seed))
        self.losses: list = []
        self.penalties: list = []
        self.start_iter = 1
        if cfg.resume:
            self._resume(cfg.resume)
        self._forward = build_forward(cfg, self.frames, self._data_scale,
                                      share)

    def _resume(self, path: str) -> None:
        state = load_checkpoint(path, {"params": self.params,
                                       "opt_state": self.opt.state_tree()})
        params_from_jax(self.model, state["params"],
                        what=f"checkpoint {path}")
        self.opt.load_state_tree(state["opt_state"])
        meta = load_meta(path)
        self.losses = list(meta.get("losses", []))
        self.penalties = list(meta.get("penalties", []))
        self.start_iter = int(meta.get("iter", 0)) + 1
        if meta.get("torch_generator") is not None:
            self.gen.set_state(torch.frombuffer(
                bytearray.fromhex(meta["torch_generator"]), dtype=torch.uint8))
        elif meta.get("noise_key") is not None:
            hi, lo = (int(w) for w in meta["noise_key"])
            self.gen.manual_seed((hi << 32) | lo)

    # -- steps ----------------------------------------------------------------

    def _loss(self) -> torch.Tensor:
        pred, target = self._forward(self.model, self.gen)
        if self.mesh is None:
            return l2_loss(pred, target)
        # l2_loss over the whole batch: this rank's sum of squares, summed
        # over the ranks
        diff = pred - target
        return torch.sqrt(_SumOverRanks.apply(torch.sum(diff * diff),
                                              self.mesh))

    def _sync(self, grads) -> list:
        """The gradients summed over the data ranks, one flat buffer."""
        if self.mesh is None:
            return grads
        from ns_tpu_torch.parallel.collectives import all_reduce_sum
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                              self.mesh, DATA_AXIS)
        return [f.view_as(g) for f, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def _step(self) -> torch.Tensor:
        loss = self._loss()
        grads = torch.autograd.grad(loss, list(self.params.values()),
                                    materialize_grads=True)
        self.opt.step(dict(zip(self.params, self._sync(grads))))
        return loss.detach()

    def train_chunk(self, n: int) -> torch.Tensor:
        """n steps; their losses (n,) stay on the device."""
        return torch.stack([self._step() for _ in range(n)])

    def _penalty(self):
        if not hasattr(self.model, "diversity_penalty"):
            return None
        with torch.no_grad():
            return self.model.diversity_penalty()

    # -- loop -----------------------------------------------------------------

    def train(self, log_every: int = 50, progress: bool = True) -> list:
        cfg = self.cfg
        from ns_tpu_torch.parallel.distributed import is_coordinator
        writer = is_coordinator()
        if writer:
            os.makedirs(cfg.out_dir, exist_ok=True)
        from ns_tpu_torch.utils.jsonl import JSONLLogger
        loss_meter = AverageMeter()
        t0 = time.perf_counter()
        log_path = os.path.join(cfg.out_dir, "metrics.jsonl")
        with (JSONLLogger(log_path) if writer
              else contextlib.nullcontext()) as jlog:
            it = self.start_iter - 1  # completed iterations
            while it < cfg.n_iters:
                n = min(cfg.ckpt_every - it % cfg.ckpt_every,
                        cfg.n_iters - it)
                losses = self.train_chunk(n)
                pen = self._penalty()
                if pen is not None:  # logged, not optimised; one read a chunk
                    losses = torch.cat([losses, pen[None].to(losses.dtype)])
                vals = losses.tolist()
                if pen is not None:
                    self.penalties.extend([vals.pop()] * n)
                for v in vals:
                    loss_meter.update(v)
                self.losses.extend(vals)
                it += n
                if (it % cfg.ckpt_every == 0 or it == cfg.n_iters) and writer:
                    self.save(it)
                    jlog.log({"loss": vals[-1], "loss_avg": loss_meter.avg},
                             iter=it)
                if progress and writer and (it % log_every < n
                                            or it == cfg.n_iters):
                    rate = (it - self.start_iter + 1) / (time.perf_counter()
                                                         - t0)
                    print(f"[{it}/{cfg.n_iters}] loss {loss_meter.avg:.4f} "
                          f"({rate:.1f} it/s)", flush=True)
        if self.mesh is not None:
            from ns_tpu_torch.parallel.distributed import barrier
            barrier("train_done")  # the coordinator's files are written
        return self.losses

    def save(self, it: int, is_best: bool = False) -> str:
        meta = {"iter": it, "losses": self.losses,
                "penalties": self.penalties,
                "grid": grid_meta(self.nx, self.ny, self.nz),
                "noise_key": None,
                "torch_generator": self.gen.get_state().numpy().tobytes().hex(),
                "config": dataclasses.asdict(self.cfg)}
        return save_checkpoint({"params": self.params,
                                "opt_state": self.opt.state_tree()},
                               self.cfg.out_dir, is_best=is_best, meta=meta)

    # -- eval -----------------------------------------------------------------

    def extrapolate(self, npz_path: Optional[str] = None) -> np.ndarray:
        """The full-horizon rollout (nt, C, *grid) that the CLI writes to
        extrapolation.npy (`extrapolate_model`)."""
        obs = load_obs(npz_path or self.cfg.npz_path, None)
        out = extrapolate_model(self.cfg, self.model,
                                torch.as_tensor(obs, device=self.device))
        return out.cpu().numpy()
