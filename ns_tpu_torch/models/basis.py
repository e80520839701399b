"""Learned-basis surrogates: x(x, y, t) = sum_k w_k(t) * f_k(x, y).

Port of `ns_tpu/models/basis.py`, the reference's neural_spectral family:
  - BasisODE: a joint K*3 coefficient neural ODE (learnable initial
    coefficients ~N(0, 1), MLP vector field K*3 -> 128 -> 128 -> K*3 with
    ReLU and ELU, weights N(0, 0.1) and zero biases, K basis fields
    (3, nx, ny) ~N(0, 1)), integrated by RK4 with the recompute adjoint;
  - BasisODE2: separate K-dim ODEs and basis banks for u, v and p;
  - BasisGRU: coefficients rolled out by a GRU(K*3 -> K*3) that feeds its
    own output back, from a learned initial vector;
  - BasisODEConv: BasisODE with the basis fields generated from grid0 by
    K stacks of 1x1 convolutions.

`forward(grid0, nt)` maps grid0 (mb, 3, nx, ny), which fixes the batch
size only, to (nt, mb, 3, nx, ny). The sum over the K basis fields is one
batched product through `ops/gemm.py` (precision None).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ns_tpu_torch.models.layers import Dense, GRUCell
from ns_tpu_torch.models.node import odeint_checkpoint
from ns_tpu_torch.ops.gemm import matmul


def _normal(*shape, device=None, dtype=None, generator=None) -> nn.Parameter:
    p = torch.empty(shape, device=device, dtype=dtype)
    with torch.no_grad():
        p.normal_(generator=generator)
    return nn.Parameter(p)


class MLPField(nn.Module):
    """The reference's ODEFunc: dim -> hidden -> hidden -> dim, ReLU then
    ELU, weights N(0, 0.1), zero biases."""

    def __init__(self, dim: int, hidden: int = 128, **kw):
        super().__init__()
        self.l1 = Dense(dim, hidden, w_std=0.1, **kw)
        self.l2 = Dense(hidden, hidden, w_std=0.1, **kw)
        self.l3 = Dense(hidden, dim, w_std=0.1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.l3(F.elu(self.l2(F.relu(self.l1(z)))))


def _expand(coeff: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """einsum('tmkc,kcxy->tmcxy'): coeff (nt, mb, K, 3), basis (K, 3, nx,
    ny) -> (nt, mb, 3, nx, ny), one product per channel c."""
    nt, mb, K, C = coeff.shape
    a = coeff.permute(3, 0, 1, 2).reshape(C, nt * mb, K)
    b = basis.transpose(0, 1).reshape(C, K, -1)
    out = matmul(a, b, None).reshape(C, nt, mb, *basis.shape[-2:])
    return out.permute(1, 2, 0, 3, 4)


class BasisODE(nn.Module):
    """The joint basis-expansion neural-ODE surrogate."""

    def __init__(self, K: int, nx: int, ny: int, method: str = "RK4", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.K, self.nx, self.ny, self.method = K, nx, ny, method
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.init_coeffs = _normal(K * 3, **kw)
        self.field = MLPField(K * 3, **kw)
        self.basis = _normal(K, 3, nx, ny, **kw)

    def forward(self, grid0: torch.Tensor, nt: int) -> torch.Tensor:
        mb = grid0.shape[0]
        z0 = self.init_coeffs.expand(mb, -1)
        coeff = odeint_checkpoint(lambda t, z: self.field(z), z0, nt,
                                  self.method)               # (nt, mb, K*3)
        return _expand(coeff.reshape(nt, mb, self.K, 3), self.basis)

    def diversity_penalty(self) -> torch.Tensor:
        return diversity_penalty(self.basis.reshape(self.K, -1))


class _FieldBank(nn.Module):
    """One field's K-dim ODE and basis bank (BasisODE2)."""

    def __init__(self, K: int, nx: int, ny: int, **kw):
        super().__init__()
        self.init_coeffs = _normal(K, **kw)
        self.field = MLPField(K, **kw)
        self.basis = _normal(K, nx, ny, **kw)


class BasisODE2(nn.Module):
    """Separate u, v, p systems (the reference's spectral_ode2)."""

    def __init__(self, K: int, nx: int, ny: int, method: str = "RK4", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.K, self.nx, self.ny, self.method = K, nx, ny, method
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.u = _FieldBank(K, nx, ny, **kw)
        self.v = _FieldBank(K, nx, ny, **kw)
        self.p = _FieldBank(K, nx, ny, **kw)

    def forward(self, grid0: torch.Tensor, nt: int) -> torch.Tensor:
        mb = grid0.shape[0]
        outs = []
        for bank in (self.u, self.v, self.p):
            z0 = bank.init_coeffs.expand(mb, -1)
            coeff = odeint_checkpoint(lambda t, z, f=bank.field: f(z), z0,
                                      nt, self.method)       # (nt, mb, K)
            w = matmul(coeff.reshape(nt * mb, self.K),
                       bank.basis.reshape(self.K, -1), None)
            outs.append(w.reshape(nt, mb, self.nx, self.ny))
        return torch.stack(outs, dim=2)                      # (nt, mb, 3, nx, ny)


class BasisGRU(nn.Module):
    """Coefficients from a GRU feeding its own hidden state back as the
    next input: x_0 = init_coeffs, h_0 = 0, h_t = GRU(h_{t-1}, x_t),
    x_{t+1} = h_t; the coefficients are the h_t."""

    def __init__(self, K: int, nx: int, ny: int, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.K, self.nx, self.ny = K, nx, ny
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.init_coeffs = _normal(K * 3, **kw)
        self.gru = GRUCell(K * 3, K * 3, **kw)
        self.basis = _normal(K, 3, nx, ny, **kw)

    def forward(self, grid0: torch.Tensor, nt: int) -> torch.Tensor:
        mb = grid0.shape[0]
        x = self.init_coeffs.expand(mb, -1)
        h = torch.zeros_like(x)
        hs = []
        for _ in range(nt):
            h = x = self.gru(h, x)
            hs.append(h)
        coeff = torch.stack(hs).reshape(nt, mb, self.K, 3)
        return _expand(coeff, self.basis)

    def diversity_penalty(self) -> torch.Tensor:
        return diversity_penalty(self.basis.reshape(self.K, -1))


_CONV_WIDTHS = (3, 16, 32, 32, 16, 3)  # the reference's spectral_ode.py:106-116


class BasisODEConv(nn.Module):
    """BasisODE with the K basis fields generated from grid0 by K stacks of
    1x1 convolutions (a per-pixel channel MLP, ReLU between layers) instead
    of free parameters."""

    def __init__(self, K: int, nx: int, ny: int, method: str = "RK4", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.K, self.nx, self.ny, self.method = K, nx, ny, method
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.init_coeffs = _normal(K * 3, **kw)
        self.field = MLPField(K * 3, **kw)
        self.conv = nn.ModuleList(
            nn.ModuleList(Dense(_CONV_WIDTHS[i], _CONV_WIDTHS[i + 1], **kw)
                          for i in range(len(_CONV_WIDTHS) - 1))
            for _ in range(K))

    @staticmethod
    def _conv_basis(layers, grid: torch.Tensor) -> torch.Tensor:
        """(mb, 3, nx, ny) -> (mb, 3, nx, ny) through one conv stack."""
        x = grid
        for i, layer in enumerate(layers):
            x = layer.channels(x)
            if i < len(layers) - 1:
                x = F.relu(x)
        return x

    def forward(self, grid0: torch.Tensor, nt: int) -> torch.Tensor:
        mb = grid0.shape[0]
        z0 = self.init_coeffs.expand(mb, -1)
        coeff = odeint_checkpoint(lambda t, z: self.field(z), z0, nt,
                                  self.method).reshape(nt, mb, self.K, 3)
        fks = torch.stack([self._conv_basis(c, grid0) for c in self.conv])
        # einsum('tmkc,kmcxy->tmcxy'): one product per (m, c)
        a = coeff.permute(1, 3, 0, 2)                        # (mb, 3, nt, K)
        b = fks.permute(1, 2, 0, 3, 4).reshape(mb, 3, self.K, -1)
        out = matmul(a, b, None).reshape(mb, 3, nt, self.nx, self.ny)
        return out.permute(2, 0, 1, 3, 4)


def diversity_penalty(W: torch.Tensor) -> torch.Tensor:
    """1 / sum_{i <= j} ||W_i - W_j||_2 (the i == j terms contribute 0, as
    in the reference's loop)."""
    diff = W[:, None, :] - W[None, :, :]
    norms = torch.sqrt(torch.sum(diff * diff, dim=-1))
    i, j = torch.triu_indices(W.shape[0], W.shape[0], device=W.device)
    return 1.0 / torch.sum(norms[i, j])
