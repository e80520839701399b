"""Flow state carried through a rollout.

Port of `ns_tpu/core/state.py`: (u, v, p) plus, for the two-step Chorin
schemes, the previous-step velocities (u^{n-1}, v^{n-1}). The numpy bridge
(`state_to_numpy`/`state_from_numpy`) carries a state across packages: a
state read back as numpy arrays from either package steps on in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_FIELDS = ("u", "v", "p", "u_prev", "v_prev")


@dataclasses.dataclass(frozen=True)
class FlowState:
    """Primitive-variable flow state.

    u, v, p: (nx, ny) fields. u_prev, v_prev: previous-step velocities for
    the Adams-Bashforth two-step history (None for single-step schemes like
    direct_fd).
    """

    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    u_prev: Optional[torch.Tensor] = None
    v_prev: Optional[torch.Tensor] = None

    def with_history(self) -> "FlowState":
        """Seed the AB history with the current fields (the reference
        initialises u1, v1 = u.copy(), v.copy())."""
        return dataclasses.replace(self, u_prev=self.u, v_prev=self.v)

    def astype(self, dtype) -> "FlowState":
        cast = lambda a: None if a is None else a.to(dtype)
        return FlowState(*(cast(getattr(self, f)) for f in _FIELDS))


def zeros_state(nx: int, ny: int, dtype=torch.float32, history: bool = False,
                device=None) -> FlowState:
    z = torch.zeros((nx, ny), dtype=dtype, device=device)
    st = FlowState(u=z, v=z, p=z)
    return st.with_history() if history else st


def rollout(step, state0: FlowState, nt: int):
    """Run `step` `nt` times from `state0`, returning the stacked
    (nt, nx, ny) u, v, p frames."""
    u_seq, v_seq, p_seq = (torch.empty((nt, *state0.u.shape),
                                       dtype=state0.u.dtype,
                                       device=state0.u.device)
                           for _ in range(3))
    state = state0
    for n in range(nt):
        state = step(state)
        u_seq[n], v_seq[n], p_seq[n] = state.u, state.v, state.p
    return u_seq, v_seq, p_seq


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """Any object with u/v/p (and optional u_prev/v_prev) fields, from either
    package, as a dict of numpy arrays; absent history is left out."""
    return {f: _to_numpy(getattr(state, f)) for f in _FIELDS
            if getattr(state, f, None) is not None}


def state_from_numpy(d: dict, device=None, dtype=torch.float64) -> FlowState:
    """Inverse of `state_to_numpy`: numpy arrays onto `device` as `dtype`."""
    conv = lambda f: (torch.tensor(np.asarray(d[f]), dtype=dtype,
                                   device=device)
                      if d.get(f) is not None else None)
    return FlowState(*(conv(f) for f in _FIELDS))
