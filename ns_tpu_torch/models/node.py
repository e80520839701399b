"""Fixed-grid neural-ODE integrators with a recompute adjoint.

Port of `ns_tpu/models/node.py`. `odeint(func, z0, nt, method)`
integrates dz/dt = func(t, z) on the uniform grid t in [0, 1), dt = 1/nt,
and returns the nt states after each step, stacked on axis 0 (z0 itself
is not included). Euler, RK2 and RK4 are the reference's Butcher schemes.
`odeint_checkpoint` runs the integration under `torch.utils.checkpoint`:
the forward pass keeps no intermediate, and the backward pass runs the
integration again and differentiates it (the recompute-adjoint semantics),
with gradients to z0 and to the parameters `func` closes over. The time
loop is a Python loop; `func` receives t as a Python float.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def _euler_step(func, t, dt, y):
    return y + dt * func(t, y)


def _rk2_step(func, t, dt, y):
    k1 = dt * func(t, y)
    k2 = dt * func(t + dt / 2.0, y + 0.5 * k1)
    return y + k2


def _rk4_step(func, t, dt, y):
    k1 = dt * func(t, y)
    k2 = dt * func(t + dt / 2.0, y + 0.5 * k1)
    k3 = dt * func(t + dt / 2.0, y + 0.5 * k2)
    k4 = dt * func(t + dt, y + k3)
    return y + k1 / 6.0 + k2 / 3.0 + k3 / 3.0 + k4 / 6.0


_STEPPERS = {"Euler": _euler_step, "RK2": _rk2_step, "RK4": _rk4_step}


def odeint(func: Callable, z0: torch.Tensor, nt: int,
           method: str = "RK4") -> torch.Tensor:
    """The nt states after each step, stacked on axis 0."""
    if method not in _STEPPERS:
        raise ValueError(f"method must be one of {sorted(_STEPPERS)}, got {method!r}")
    stepper = _STEPPERS[method]
    dt = 1.0 / float(nt)
    zs, z = [], z0
    for n in range(nt):
        z = stepper(func, n * dt, dt, z)
        zs.append(z)
    return torch.stack(zs)


def odeint_checkpoint(func: Callable, z0: torch.Tensor, nt: int,
                      method: str = "RK4") -> torch.Tensor:
    """`odeint` whose backward pass recomputes the forward integration
    instead of storing its intermediates."""
    return checkpoint(odeint, func, z0, nt, method, use_reentrant=False)


# --- the reference's entry points (migration aliases) -----------------------


def odesolver(func: Callable, z0: torch.Tensor, options: dict) -> torch.Tensor:
    """The reference ANODE entry signature: options carries {'Nt': nt,
    'method': 'Euler'|'RK2'|'RK4'}."""
    return odeint(func, z0, int(options["Nt"]),
                  method=options.get("method", "RK4"))


def odesolver_adjoint(func: Callable, z0: torch.Tensor,
                      options: dict) -> torch.Tensor:
    """The reference recompute-adjoint entry: the same contract, the
    backward pass runs the integration again."""
    return odeint_checkpoint(func, z0, int(options["Nt"]),
                             method=options.get("method", "RK4"))
