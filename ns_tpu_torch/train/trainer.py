"""The training configuration shared by training, evaluation and serving.

Port of the configuration part of `ns_tpu/train/trainer.py`: the model
families, `TrainConfig` with every field, default and check of the JAX
package's (a checkpoint's `meta["config"]` rebuilds it field by field),
the observation loader and `rollout_post`, the per-step constraint map of
the operator families' rollouts. The trainer itself is not ported yet; the
3D families' rollout maps raise "not yet ported".
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

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

NOT_PORTED = "is not yet ported to ns_tpu_torch, see ROADMAP.md"


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
    projection for fno with fno_project. One definition for training
    feedback, evaluation and serving."""
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
        raise NotImplementedError(f"the fno3d rollout filter {NOT_PORTED}")
    if cfg.model in ("fno3d_w", "fno3d_a") and cfg.fno_dealias:
        raise NotImplementedError(f"the {cfg.model} dealias filter "
                                  f"{NOT_PORTED}")
    return None
