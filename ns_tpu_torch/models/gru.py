"""Full-field next-step GRU baseline.

Port of `ns_tpu/models/gru.py` (the reference's rnn.py): flattened
(u, v, p) frames (3*nx*ny) through a GRU(input -> hidden) and a two-layer
MLP head predicting the next frame. `forward` is the teacher-forced
training pass, `extrapolate` the closed-loop rollout that feeds its
predictions back; the mismatch between them is the reference's design.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ns_tpu_torch.models.layers import Dense, GRUCell


class FullFieldGRU(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.input_dim, self.hidden_dim = input_dim, hidden_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.gru = GRUCell(input_dim, hidden_dim, **kw)
        self.head1 = Dense(hidden_dim, hidden_dim, **kw)
        self.head2 = Dense(hidden_dim, input_dim, **kw)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        return self.head2(F.relu(self.head1(h)))

    def forward(self, obs_seq: torch.Tensor) -> torch.Tensor:
        """Teacher-forced: obs_seq (mb, nt, D) -> (mb, nt, D). The input
        projection of every step is one product (`GRUCell.input_projection`),
        so the large w_ih is read once."""
        mb, nt = obs_seq.shape[:2]
        gi = self.gru.input_projection(obs_seq)              # (mb, nt, 3H)
        h = obs_seq.new_zeros((mb, self.hidden_dim))
        hs = []
        for t in range(nt):
            h = self.gru.step(h, gi[:, t])
            hs.append(h)
        return self._head(torch.stack(hs, dim=1))

    def extrapolate(self, obs0: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Closed loop: obs0 (mb, D) -> (mb, n_steps, D), each prediction
        fed back as the next input; the hidden state persists across
        steps."""
        h = obs0.new_zeros((obs0.shape[0], self.hidden_dim))
        x, ys = obs0, []
        for _ in range(n_steps):
            h = self.gru(h, x)
            x = self._head(h)
            ys.append(x)
        if not ys:
            return obs0.new_zeros((obs0.shape[0], 0, self.input_dim))
        return torch.stack(ys, dim=1)
