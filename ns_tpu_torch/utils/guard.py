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

Debug tools, ported from the same JAX module: `enable_nan_checks` (the
counterpart of jax_debug_nans: raise at the first op that makes a NaN) and
`shadow_check` (a float64 shadow run of a function, with each output's
deviation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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


# ---------------------------------------------------------------------------
# Debug tripwires
# ---------------------------------------------------------------------------

class _NaNMode(TorchDispatchMode):
    """Raise FloatingPointError at the first op whose floating output holds
    a NaN (the port's jax_debug_nans)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out):
            if ((t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN produced by {func} (enable_nan_checks)")
        return out


_nan_state: dict = {}


def enable_nan_checks(enable: bool = True) -> None:
    """Debug-mode NaN tripwire, the counterpart of JAX's jax_debug_nans:
    every op whose floating output holds a NaN raises FloatingPointError
    naming the op, and autograd's anomaly mode is on (a backward op that
    makes a NaN raises too, with the forward op's trace). A debug tool: it
    reads every op's output on the host, so it synchronizes the device
    after every op. enable_nan_checks(False) restores both."""
    if enable and "mode" not in _nan_state:
        _nan_state["anomaly"] = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(True)
        mode = _NaNMode()
        mode.__enter__()
        _nan_state["mode"] = mode
    elif not enable and "mode" in _nan_state:
        _nan_state.pop("mode").__exit__(None, None, None)
        torch.autograd.set_detect_anomaly(_nan_state.pop("anomaly"))


def shadow_check(fn: Callable, *args, rtol: float = 1e-4,
                 atol: float = 1e-5):
    """Numerics validation by a dtype shadow run: fn on the args as given,
    then again with every float tensor upcast to float64 and every complex
    one to complex128. Returns (lo, hi, devs): the two results and, in the
    result's structure, each tensor's max abs deviation as a Python float
    (a complex deviation is |a - b| over both components). All deviations
    are reduced on the device and read back in one copy. rtol and atol are
    accepted for signature parity with the JAX function, which also leaves
    the judgement to the caller."""
    def upcast(x):
        if isinstance(x, torch.Tensor):
            if x.is_complex():
                return x.to(torch.complex128)
            if x.is_floating_point():
                return x.to(torch.float64)
        return x

    lo = fn(*args)
    hi = fn(*_map(upcast, list(args)))

    def dev(a, b):
        up = torch.complex128 if a.is_complex() else torch.float64
        return (a.to(up) - b.to(up).to(a.device)).abs().max()

    flat = [dev(a, b) for a, b in zip(_leaves(lo), _leaves(hi))]
    values = iter(torch.stack([d.to(flat[0].device) for d in flat]).tolist()
                  if flat else [])
    devs = _map(lambda _: next(values), lo)
    return lo, hi, devs
