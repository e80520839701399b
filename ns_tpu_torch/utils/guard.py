"""Failure detection for rollouts: a divergence guard that freezes the
state at its last good value.

Port of `ns_tpu/utils/guard.py::guarded_rollout` (the reference has no
failure handling: its solvers run to completion or crash). Once the state
goes non-finite or exceeds a magnitude bound, the rollout keeps the last
good state, records the first bad step, and the caller gets the frozen
frames instead of a poisoned rollout.

The JAX rollout skips the solver after a trip (`lax.cond` inside one
scan). Here the trip flag and the first bad step stay on the device: each
step selects the old or the new state with `torch.where`, and the flag is
read once, by the caller, after the rollout, so the loop never waits on
the host. The price is that the solver keeps stepping the frozen state
after a trip; the frames and `first_bad_step` are JAX's.

A state is a tensor, or a tuple, list, dict or dataclass (FlowState) of
them; None fields are left alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


class GuardedCarry(NamedTuple):
    state: object                 # the solver state
    bad: torch.Tensor             # bool scalar: tripped
    first_bad_step: torch.Tensor  # int32: step of the first trip (-1 clean)


def _leaves(state) -> list:
    if isinstance(state, torch.Tensor):
        return [state]
    if dataclasses.is_dataclass(state):
        state = [getattr(state, f.name) for f in dataclasses.fields(state)]
    elif isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in _leaves(s)]
    return []


def _map(fn, *states):
    """fn over the tensors of states of one structure."""
    s0 = states[0]
    if isinstance(s0, torch.Tensor):
        return fn(*states)
    if s0 is None:
        return None
    if dataclasses.is_dataclass(s0):
        return dataclasses.replace(s0, **{
            f.name: _map(fn, *(getattr(s, f.name) for s in states))
            for f in dataclasses.fields(s0)})
    if isinstance(s0, dict):
        return {k: _map(fn, *(s[k] for s in states)) for k in s0}
    if isinstance(s0, (tuple, list)):
        return type(s0)(_map(fn, *parts) for parts in zip(*states))
    return s0


def state_is_bad(state, max_abs: float = 1e6) -> torch.Tensor:
    """True (a device bool scalar) if any tensor of the state is
    non-finite or exceeds max_abs in magnitude."""
    flags = [(~torch.isfinite(a)).any() | (a.abs() > max_abs).any()
             for a in _leaves(state)]
    return torch.stack(flags).any()


def guarded_rollout(step_fn: Callable, state0, nt: int,
                    max_abs: float = 1e6, collect: bool = True):
    """Run nt steps of `step_fn` under the divergence guard.

    Returns (final GuardedCarry, stacked states or None): with `collect`,
    each tensor of the state stacked over the nt steps, (nt, ...). After a
    trip every later frame holds the frozen (last good) state. Nothing in
    the loop reads a device value on the host."""
    dev = _leaves(state0)[0].device
    steps = torch.arange(nt, dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    first = torch.full((), -1, dtype=torch.int32, device=dev)
    state, frames = state0, []
    for n in range(nt):
        new_state = step_fn(state)
        now_bad = state_is_bad(new_state, max_abs)
        # a step that produced a bad state, or any step after a trip, keeps
        # the old state
        hold = bad | now_bad
        state = _map(lambda new, old: torch.where(hold, old, new),
                     new_state, state)
        first = torch.where(now_bad & (first < 0), steps[n], first)
        bad = hold
        if collect:
            frames.append(state)
    stacked = (_map(lambda *a: torch.stack(a), *frames)
               if collect and frames else None)
    return GuardedCarry(state, bad, first), stacked
