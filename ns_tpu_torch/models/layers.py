"""Building blocks of the surrogate models: the dense layer and the GRU cell.

Port of `ns_tpu/models/layers.py`. Each block is an `nn.Module` whose
parameters carry the JAX package's names and layouts, so a JAX parameter
tree maps onto `named_parameters()` by key path (`lift/w` is the module
path `lift.w`; `train/checkpoint.py::params_from_jax`):
  - a dense `w` is stored (in, out), as JAX stores it, and applied as
    x @ w + b;
  - the GRU's `w_ih` (in, 3H) and `w_hh` (H, 3H) hold the gates in the
    order r, z, n: `torch.nn.GRUCell`'s order, transposed.

The GRU cell follows the standard gate equations (those of
`torch.nn.GRU`):

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh  (x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Initialisation draws from the JAX init's distributions (a torch PRNG
cannot reproduce JAX's values): uniform(+-1/sqrt(in)) for a default dense
layer, N(0, w_std) with a zero bias when `w_std` is given, and
uniform(+-1/sqrt(H)) for the GRU. `generator` is a `torch.Generator` on
the parameters' device (None: torch's default one). Every product runs
through `ops/gemm.py` at precision None: fp32 with TF32 off on the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ns_tpu_torch.ops.gemm import matmul


def _param(*shape, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Dense(nn.Module):
    """x @ w + b with w stored (in, out)."""

    def __init__(self, in_dim: int, out_dim: int, w_std: float | None = None,
                 *, device=None, dtype=None, generator=None):
        super().__init__()
        self.in_dim, self.out_dim, self.w_std = in_dim, out_dim, w_std
        self.w = _param(in_dim, out_dim, device=device, dtype=dtype)
        self.b = _param(out_dim, device=device, dtype=dtype)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        if self.w_std is None:
            bound = 1.0 / math.sqrt(self.in_dim)
            self.w.uniform_(-bound, bound, generator=generator)
            self.b.uniform_(-bound, bound, generator=generator)
        else:
            self.w.normal_(0.0, self.w_std, generator=generator)
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return matmul(x, self.w, None) + self.b

    def channels(self, h: torch.Tensor, spatial: int = 2) -> torch.Tensor:
        """The layer on the channel axis of (..., in, *grid) -> (..., out,
        *grid), `spatial` grid axes: one product w^T @ h per sample, no
        transposes of h."""
        out = matmul(self.w.T, h.flatten(-spatial), None) + self.b[:, None]
        return out.unflatten(-1, h.shape[-spatial:])


class GRUCell(nn.Module):
    """One GRU step, h' = cell(h, x) (the JAX argument order; torch's
    `nn.GRUCell` takes (x, h))."""

    def __init__(self, in_dim: int, hidden: int, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.in_dim, self.hidden = in_dim, hidden
        kw = dict(device=device, dtype=dtype)
        self.w_ih = _param(in_dim, 3 * hidden, **kw)
        self.w_hh = _param(hidden, 3 * hidden, **kw)
        self.b_ih = _param(3 * hidden, **kw)
        self.b_hh = _param(3 * hidden, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.hidden)
        for p in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            p.uniform_(-bound, bound, generator=generator)

    def input_projection(self, x: torch.Tensor) -> torch.Tensor:
        """gi = x @ w_ih + b_ih, which does not depend on the recurrence: a
        teacher-forced pass takes it for every step as one product, so the
        large w_ih is read once and not once a step."""
        return matmul(x, self.w_ih, None) + self.b_ih

    def step(self, h: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
        """The GRU step from a precomputed input projection gi."""
        gh = matmul(h, self.w_hh, None) + self.b_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """h (..., H), x (..., in) -> h' (..., H)."""
        return self.step(h, self.input_projection(x))
