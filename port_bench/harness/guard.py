"""What a run refuses: a machine without the cards a cell asks for, and a
process that has loaded JAX or the JAX package."""

from __future__ import annotations

import sys

# top-level module names the measured process may not hold; compared whole,
# so the port (`ns_tpu_torch`) and e.g. `jaxtyping` pass
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ns_tpu"})


class NoCard(RuntimeError):
    """The machine lacks the CUDA devices a cell asks for."""


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of FORBIDDEN, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def require_cards(chips: int) -> None:
    """Raise NoCard unless CUDA is available with at least `chips` cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "measures the card and has no CPU mode")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoCard(f"the cell asks for {chips} cards, the machine has "
                     f"{have}")


def entry_seed(seed: int, index: int) -> int:
    """A 63-bit seed for pool entry `index` of run seed `seed` (splitmix64
    of both): entries of one run, and runs of different seeds, draw
    independent streams."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) % (1 << 64)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (x ^ (x >> 31)) >> 1
