"""Training metrics and observability helpers.

Port of `ns_tpu/train/metrics.py` (the reference's utils): AverageMeter,
the global L2 loss, mean_squared_error, log_normal_pdf and normal_kl on
tensors, the host-side relative L2 error of every surrogate study, and
the physics observables (FD divergence residual, kinetic energy).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Global L2 norm of the residual over all elements, the loss of every
    reference training script."""
    diff = pred - target
    return torch.sqrt(torch.sum(diff * diff))


def mean_squared_error(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Per-sample-mean MSE, averaged over the batch."""
    b = pred.shape[0]
    return torch.mean(torch.mean((pred.reshape(b, -1)
                                  - true.reshape(b, -1)) ** 2, dim=1))


def log_normal_pdf(x: torch.Tensor, mean: torch.Tensor,
                   logvar: torch.Tensor) -> torch.Tensor:
    const = math.log(2.0 * np.pi)
    return -0.5 * (const + logvar + (x - mean) ** 2 / torch.exp(logvar))


def normal_kl(mu1, lv1, mu2, lv2) -> torch.Tensor:
    v1, v2 = torch.exp(lv1), torch.exp(lv2)
    lstd1, lstd2 = lv1 / 2.0, lv2 / 2.0
    return lstd2 - lstd1 + (v1 + (mu1 - mu2) ** 2) / (2.0 * v2) - 0.5


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel_l2(pred, obs) -> float:
    """Global relative L2 error ||pred - obs|| / ||obs||, on the host (numpy
    arrays or tensors)."""
    pred, obs = _numpy(pred), _numpy(obs)
    return float(np.linalg.norm(pred - obs) / np.linalg.norm(obs))


def divergence_residual_fd(u: torch.Tensor, v: torch.Tensor, dx: float,
                           dy: float) -> torch.Tensor:
    """Max |du/dx + dv/dy| on the interior, central differences in the
    reference direct_fd axis convention (x along axis 1)."""
    div = ((u[1:-1, 2:] - u[1:-1, :-2]) / (2 * dx)
           + (v[2:, 1:-1] - v[:-2, 1:-1]) / (2 * dy))
    return torch.max(torch.abs(div))


def kinetic_energy(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.mean(u * u + v * v)
