"""The training optimizer: Adam under the configured learning-rate schedule,
with optional global-norm gradient clipping.

Port of `ns_tpu/train/trainer.py::make_optimizer` and of the optax
transforms it chains (`adam`, `linear_schedule`, `cosine_decay_schedule`,
`warmup_cosine_decay_schedule`, `clip_by_global_norm`), in optax's own
arithmetic, so the two packages' trajectories agree step for step and each
resumes the other's checkpoints (`torch.optim.Adam` folds the bias
corrections in another order):

    mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   count += 1
    update = -lr(t) * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

with b1 0.9, b2 0.999, eps 1e-8 (optax's eps_root 0 adds nothing), and
lr(t) the schedule at its own count t before that count is incremented.
Clipping runs first: g <- where(|g| < c, g, g / |g| * c) over the global
norm |g| of every gradient, on the device (no host read).

The counts live on the host (bias corrections and the schedule value are
Python floats passed to the kernels, so a step reads nothing back); the
device copies exist only in `state_tree`, which lays the state out under
optax's key paths, as `make_optimizer(cfg).init` builds it:
  - constant lr:      [adam, {}]
  - a schedule:       [adam, {".count": t}]
  - with grad_clip:   [{}, <one of the above>]
where adam = {".count": count, ".mu": {path: mu}, ".nu": {path: nu}} and
`path` is the parameter's JAX key path. Counts are int32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


# --- schedules: count -> learning rate (host floats) -------------------------


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax.linear_schedule (polynomial, power 1, from step 0). optax
    evaluates it in float32 (the int32 count promotes to float32), so it is
    evaluated here in float32 too."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(max(count, 0), transition_steps))
        frac = f32(1) - c / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(float(count), float(decay_steps))
        cosine_decay = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: linear warm-up to the peak, then
    a cosine decay over the rest of `decay_steps` (which includes the
    warm-up). The join takes the warm-up's float32, so the decay's value is
    rounded to float32 too."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warm(count)
        return float(np.float32(decay(count - warmup_steps)))
    return schedule


def make_schedule(cfg):
    """The learning-rate schedule of `cfg` (a TrainConfig), or None for the
    reference's constant lr; the arguments are make_optimizer's."""
    horizon = (cfg.schedule_horizon if cfg.schedule_horizon is not None
               else cfg.n_iters)
    if cfg.lr_schedule == "cosine":
        decay = max(horizon - cfg.warmup_iters, 1)
        if cfg.warmup_iters > 0:
            return warmup_cosine_decay_schedule(
                0.0, cfg.lr, cfg.warmup_iters, cfg.warmup_iters + decay)
        return cosine_decay_schedule(cfg.lr, decay)
    if cfg.warmup_iters > 0:
        return linear_schedule(0.0, cfg.lr, cfg.warmup_iters)
    return None


@dataclasses.dataclass(frozen=True)
class AdamSpec:
    """The fields of a TrainConfig that `Adam` reads, for `optax.adam(lr)`:
    a constant rate, no clipping (train/ensemble.py's functional API)."""

    lr: float = 1e-3
    grad_clip: float = 0.0
    lr_schedule: str = "constant"
    warmup_iters: int = 0
    schedule_horizon: Optional[int] = None
    n_iters: int = 0


def adam(lr: float) -> AdamSpec:
    """The optimizer `optax.adam(lr)` names, for `Adam(adam(lr), params)`."""
    return AdamSpec(lr=lr)


def _tree_order(path: str):
    """Sort key of a key path in JAX's leaf order (dict keys sorted, list
    indices by number)."""
    return [(0, int(k), "") if k.isdigit() else (1, 0, k)
            for k in path.split("/")]


class Adam:
    """`make_optimizer(cfg)` over the parameters {JAX key path: tensor} of
    one model. `step(grads)` updates the parameters in place."""

    def __init__(self, cfg, params: dict):
        self.lr = cfg.lr
        self.clip = cfg.grad_clip
        self.schedule = make_schedule(cfg)
        self.names = sorted(params, key=_tree_order)
        self.params = [params[n] for n in self.names]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.schedule_count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        """One update from {JAX key path: gradient}."""
        g = [grads[n] for n in self.names]
        if self.clip > 0:
            total = 0
            for x in g:
                total = total + torch.sum(x * x)
            norm = torch.sqrt(total)
            keep = norm < self.clip
            g = [torch.where(keep, x, x / norm * self.clip) for x in g]
        self.mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1),
                                     torch._foreach_mul(self.mu, B1))
        self.nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2),
            torch._foreach_mul(self.nu, B2))
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1 - B1 ** self.count)
        den = torch._foreach_sqrt(torch._foreach_div(self.nu,
                                                     1 - B2 ** self.count))
        torch._foreach_add_(den, EPS)
        update = torch._foreach_div(mu_hat, den)
        if self.schedule is None:
            lr = self.lr
        else:
            lr = self.schedule(self.schedule_count)
            self.schedule_count += 1
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)

    # -- state in optax's layout ----------------------------------------------

    def state_tree(self) -> list:
        """The state as `make_optimizer(cfg).init` lays it out (module
        docstring), counts as int32 scalars on the host."""
        count = lambda c: torch.tensor(c, dtype=torch.int32)  # noqa: E731
        adam = {".count": count(self.count),
                ".mu": dict(zip(self.names, self.mu)),
                ".nu": dict(zip(self.names, self.nu))}
        tree = [adam, {} if self.schedule is None
                else {".count": count(self.schedule_count)}]
        return [{}, tree] if self.clip > 0 else tree

    @torch.no_grad()
    def load_state_tree(self, tree) -> None:
        """Restore from a tree in `state_tree`'s layout (numpy or tensor
        leaves, as `checkpoint.load_checkpoint` returns them)."""
        tree = tree[1] if self.clip > 0 else tree
        adam = tree[0]
        self.count = int(np.asarray(adam[".count"]))
        for i, n in enumerate(self.names):
            self.mu[i].copy_(torch.as_tensor(np.asarray(adam[".mu"][n])))
            self.nu[i].copy_(torch.as_tensor(np.asarray(adam[".nu"][n])))
        if self.schedule is not None:
            self.schedule_count = int(np.asarray(tree[1][".count"]))
