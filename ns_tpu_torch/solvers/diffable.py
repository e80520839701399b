"""Differentiable rollouts: gradients through the physics.

Port of `ns_tpu/solvers/diffable.py`. The solver steps are plain torch
functions, so the same rollout code is differentiable end to end with
torch autograd: a loss on a rollout's output gives gradients with respect
to initial conditions or physics parameters (the adjoint method for free),
which serves data assimilation and initial-condition recovery.

Memory: an nt-step rollout's backward pass stores O(nt) states;
`rollout_chunked_remat` runs each chunk of steps under
`torch.utils.checkpoint`, storing O(nt / chunk + chunk) states instead.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ns_tpu_torch.solvers import spectral_periodic as sp


def rollout_final(step_fn: Callable, state0, nt: int):
    """Plain differentiable rollout to the final state."""
    state = state0
    for _ in range(nt):
        state = step_fn(state)
    return state


def rollout_chunked_remat(step_fn: Callable, state0, nt: int,
                          chunk: int = 16):
    """Rollout with per-chunk rematerialization: the backward pass
    recomputes inside each chunk instead of storing every step."""
    if nt % chunk:
        raise ValueError(f"nt={nt} must be divisible by chunk={chunk}")

    def run_chunk(state):
        return rollout_final(step_fn, state, chunk)

    state = state0
    for _ in range(nt // chunk):
        state = checkpoint(run_chunk, state, use_reentrant=False)
    return state


def fit_initial_vorticity(cfg: sp.SpectralPeriodicConfig, target_w, nt: int,
                          n_iters: int = 50, lr: float = 0.5, w_init=None,
                          chunk: int = 0, device=None):
    """Optimise the initial vorticity of the periodic spectral solver
    (rfft2 layout: cfg's fft or padded matmul engine) so the rollout's
    final state matches `target_w`: gradient descent through the solver.
    Runs on `device` (default: target_w's own when it is a tensor, else
    CUDA; core/device.py). The losses stay on the device and are read back
    once at the end. Returns (w0, losses), losses[i] the loss at the
    initial vorticity before descent step i."""
    target = sp._as_vorticity(cfg, target_w, device)
    dev = target.device
    ops = sp.make_ops(cfg, dev)
    transforms = sp.make_transforms(cfg, dev)
    step_pair, _ = sp.make_step(cfg, dev)

    def step(carry):
        new_carry, _ = step_pair(carry)
        return new_carry

    def loss_fn(w0):
        w_hat = torch.fft.rfft2(w0)
        carry = (w_hat, sp.nonlinear_term(w_hat, ops, cfg, transforms))
        if chunk:
            carry = rollout_chunked_remat(step, carry, nt, chunk)
        else:
            carry = rollout_final(step, carry, nt)
        w_fin = torch.fft.irfft2(carry[0], s=(cfg.nx, cfg.ny))
        return torch.mean((w_fin - target) ** 2)

    w0 = (torch.zeros((cfg.nx, cfg.ny), dtype=cfg.real_dtype, device=dev)
          if w_init is None else sp._as_vorticity(cfg, w_init, dev))
    losses = torch.empty(n_iters, dtype=cfg.real_dtype, device=dev)
    for i in range(n_iters):
        w = w0.detach().requires_grad_(True)
        loss = loss_fn(w)
        (g,) = torch.autograd.grad(loss, w)
        losses[i] = loss.detach()
        w0 = (w - lr * g).detach()
    return w0, [float(x) for x in np.asarray(losses.cpu())]
