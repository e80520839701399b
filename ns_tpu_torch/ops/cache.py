"""Cached builders of constant device tables (DFT matrices, masks,
wavenumbers, projectors).

A table is built outside inference mode whatever the caller's mode: one
first built by a served rollout (`torch.inference_mode`) is later saved
for a training backward, which an inference tensor cannot be.
"""

from __future__ import annotations

from functools import lru_cache

import torch


def device_table(maxsize: int = 16):
    """`functools.lru_cache(maxsize)` over a table builder run with
    inference mode off."""
    def wrap(build):
        return lru_cache(maxsize=maxsize)(torch.inference_mode(False)(build))
    return wrap
