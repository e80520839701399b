"""Declarative boundary conditions on torch tensors.

Port of `ns_tpu/core/bc.py`: a BC names one edge of a 2D field and either
pins it to a value (Dirichlet) or imposes a one-sided-difference derivative
(Neumann). Edge naming follows the reference exactly:

    left   -> A[0,  :]        right -> A[-1, :]
    bottom -> A[:,  0]        top   -> A[:, -1]

BCs are applied *in list order*: a later BC overwrites an earlier one at a
shared corner, and a Neumann edge reads whatever its inner neighbour holds at
that moment, so `apply_bcs` preserves the order.

`apply_bc`/`apply_bcs` return a new tensor and leave their input untouched,
as the JAX package's functional updates do. They act on the last two axes,
so a (B, nx, ny) batch of members takes the list on every member (the JAX
package's FD ensemble applies it under vmap).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

_SIDES = ("left", "right", "bottom", "top")
_KINDS = ("dirichlet", "neumann")


@dataclasses.dataclass(frozen=True)
class BC:
    """One boundary condition on one edge of a 2D field.

    Attributes:
      kind:  'dirichlet' (pin edge to `value`) or 'neumann' (impose the
             one-sided derivative `value` across the edge).
      value: the pinned value / imposed derivative.
      side:  'left' | 'right' | 'bottom' | 'top' (reference edge naming).
      dx, dy: grid spacings used by the Neumann one-sided difference.
    """

    kind: str
    value: float
    side: str
    dx: float = 0.0
    dy: float = 0.0

    def __post_init__(self):
        if self.side not in _SIDES:
            raise ValueError(f"side must be one of {_SIDES}, got "
                             f"{self.side!r}")
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be dirichlet|neumann, got "
                             f"{self.kind!r}")

    # Mirrors of the reference's attribute names.
    @property
    def type(self) -> str:
        return self.kind

    @property
    def boundary(self) -> str:
        return self.side

    def edge_term(self) -> float:
        """The value the edge is set to (Dirichlet), or the signed offset
        added to the inner neighbour (Neumann: left A[1]-dx*g, right
        A[-2]+dx*g, bottom A[:,1]-dy*g, top A[:,-2]+dy*g), formed in double.
        The CUDA kernels receive this same number, so the plain and kernel
        edge writes do the same arithmetic."""
        v = float(self.value)
        if self.kind == "dirichlet":
            return v
        h = self.dx if self.side in ("left", "right") else self.dy
        return h * v if self.side in ("right", "top") else -(h * v)


def dirichlet(value: float, side: str, dx: float = 0.0, dy: float = 0.0) -> BC:
    return BC("dirichlet", value, side, dx, dy)


def neumann(value: float, side: str, dx: float, dy: float) -> BC:
    return BC("neumann", value, side, dx, dy)


def _apply_in_place(A: torch.Tensor, bc: BC) -> None:
    t = bc.edge_term()
    if bc.side == "left":
        A[..., 0, :] = t if bc.kind == "dirichlet" else A[..., 1, :] + t
    elif bc.side == "right":
        A[..., -1, :] = t if bc.kind == "dirichlet" else A[..., -2, :] + t
    elif bc.side == "bottom":
        A[..., :, 0] = t if bc.kind == "dirichlet" else A[..., :, 1] + t
    else:
        A[..., :, -1] = t if bc.kind == "dirichlet" else A[..., :, -2] + t


def apply_bc(A: torch.Tensor, bc: BC) -> torch.Tensor:
    """Apply a single BC to a 2D field (or a batch of them), returning a
    new tensor."""
    out = A.clone()
    _apply_in_place(out, bc)
    return out


def apply_bcs(A: torch.Tensor, bcs: Sequence[BC]) -> torch.Tensor:
    """Apply a list of BCs in order (reference sequential-list semantics),
    returning a new tensor."""
    out = A.clone()
    for bc in bcs:
        _apply_in_place(out, bc)
    return out


def bcs_from_reference(bcs) -> list[BC]:
    """Convert BC objects of another package (any object with
    kind/value/side/dx/dy attributes, e.g. an `ns_tpu` BC) into this
    package's BCs, preserving list order. Nothing is imported from the
    other package."""
    return [BC(b.kind, float(b.value), b.side, float(b.dx), float(b.dy))
            for b in bcs]


# --- reference-named constructors (migration aliases) -----------------------


def DirichletBoundaryCondition(value, boundary, dx=0.0, dy=0.0) -> BC:
    return BC("dirichlet", value, boundary, float(dx), float(dy))


def NeumannBoundaryCondition(value, boundary, dx, dy) -> BC:
    return BC("neumann", value, boundary, float(dx), float(dy))
