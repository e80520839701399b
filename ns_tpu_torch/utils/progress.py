"""Per-chunk progress reporting for long rollouts.

Port of `ns_tpu/utils/progress.py::chunked_simulate`. The reference
tqdm-wraps every solver's python time loop. The JAX package runs the same
jitted step in scan chunks and ticks a tqdm bar once a chunk; this port
runs the eager step `chunk` times, keeps the chunk's frames on the device,
copies them to the host once a chunk and ticks the bar then. Without tqdm
it prints one plain line a chunk.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def chunked_simulate(step_fn: Callable, state0, nt: int,
                     extract: Callable, chunk: int = 25,
                     progress: bool = True, desc: str = "rollout"):
    """Roll `state0` forward nt steps, collecting `extract(state) ->
    {name: tensor}` after every step into host-stacked (nt, ...) numpy
    arrays, with a progress report per chunk of `chunk` steps. Returns
    ({name: np.ndarray}, final_state)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk} (<= 0 would "
                         "spin forever dispatching empty programs)")
    bar = None
    if progress:
        try:
            from tqdm import tqdm
            bar = tqdm(total=nt, desc=desc, unit="step")
        except ImportError:
            bar = None
    outs, state, t = {}, state0, 0
    try:
        while t < nt:
            n = min(chunk, nt - t)
            frames = []
            for _ in range(n):
                state = step_fn(state)
                frames.append(extract(state))
            for name in frames[0]:
                host = torch.stack([f[name] for f in frames]).cpu().numpy()
                if name not in outs:
                    outs[name] = np.empty((nt,) + host.shape[1:],
                                          dtype=host.dtype)
                outs[name][t:t + n] = host
            t += n
            if bar is not None:
                bar.update(n)
            elif progress:
                print(f"{desc}: step {t}/{nt}")
    finally:
        if bar is not None:
            bar.close()
    if not outs:  # nt == 0: empty frames of the extracted shapes
        outs = {name: np.empty((0,) + tuple(a.shape),
                               dtype=a.cpu().numpy().dtype)
                for name, a in extract(state0).items()}
    return outs, state
