"""Where the port's entry points run.

The solver systems, the rollout helpers that take host arrays and the CLI
run on the card unless the caller asks for the CPU. `None` means CUDA; a
request for CUDA on a machine without a card raises (it never falls back
to the CPU); an explicit "cpu" runs on the CPU.
"""

from __future__ import annotations

import torch

NO_CUDA = ("no CUDA device is available; pass device=\"cpu\" "
           "(--device cpu on the command line) to run on the CPU")


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: `device`, or CUDA when it
    is None. Raises RuntimeError for a CUDA device on a machine without
    one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    return dev
