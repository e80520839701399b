"""Streaming rollout writer: time horizons larger than device memory.

Port of `ns_tpu/io/streaming.py`. The reference materializes whole (nt,
nx, ny) rollouts in memory before one np.savez at the end
(direct_fd/simulate.py:129-144,194); 200 frames of u/v/p at 1024^2 float32
are already 2.4 GB. This writer runs the rollout in chunks of `chunk`
eager steps, keeps one chunk of extracted frames on the card, copies each
field to the host once a chunk (as `utils/progress.py` does) and hands it
to an async .npy writer (io/native_writer.py), which stores it while the
next chunk computes. So the card never holds more than `chunk` frames and
the host never more than one chunk.

The JAX module keeps an LRU of jitted chunk runners keyed on (step_fn,
extract); the port compiles nothing, so it has no counterpart.

Output files are standard .npy (np.load-compatible); the npz path
(cli/run_solver.py) remains for reference-format interchange.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch


def _open(out_dir: str, name: str, shape: tuple, dtype, writer: str):
    path = os.path.join(out_dir, f"{name}.npy")
    if writer == "memmap":
        return np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                         shape=shape)
    from ns_tpu_torch.io.native_writer import AsyncNpyWriter
    return AsyncNpyWriter(path, shape, dtype=dtype, backend=writer)


def stream_rollout(step_fn: Callable, state0, nt: int,
                   extract: Callable, out_dir: str,
                   chunk: int = 64, dtype=np.float32,
                   writer: str = "auto") -> Dict[str, str]:
    """Roll `state0` forward nt steps with `step_fn`, streaming the
    per-step outputs of `extract(state) -> {name: tensor}` into
    `out_dir/<name>.npy` files of shape (nt, *tensor.shape).

    Returns {name: path}. The rollout runs in ceil(nt/chunk) chunks, each
    field copied to the host once a chunk.

    `writer` selects the host IO path: 'auto'/'native'/'thread'/'sync'
    use the async frame writer (io/native_writer.py — file IO overlaps
    the next chunk's work on the card; 'auto' prefers the C++ backend),
    'memmap' keeps the synchronous np memmap store.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    os.makedirs(out_dir, exist_ok=True)
    outs: dict = {}
    # try/finally: a mid-rollout failure (device error, bad step_fn) must
    # not leak the writers' fds/worker threads/native ring buffers —
    # stream_rollout also runs inside long-lived serving processes
    closed = False
    try:
        if nt == 0:  # empty files of the extracted shapes
            for name, a in extract(state0).items():
                outs[name] = _open(out_dir, name, (0,) + tuple(a.shape),
                                   dtype, writer)
        state, bufs, t = state0, {}, 0
        while t < nt:
            n = min(chunk, nt - t)
            for i in range(n):
                state = step_fn(state)
                for name, a in extract(state).items():
                    if name not in bufs:  # one chunk of frames on the card
                        bufs[name] = torch.empty(
                            (min(chunk, nt),) + tuple(a.shape),
                            dtype=a.dtype, device=a.device)
                    bufs[name][i] = a
            for name, buf in bufs.items():
                host = buf[:n].cpu().numpy()  # one host copy a chunk
                if name not in outs:
                    outs[name] = _open(out_dir, name,
                                       (nt,) + host.shape[1:], dtype, writer)
                if writer == "memmap":
                    outs[name][t:t + n] = host
                else:
                    # returns at once; the disk write overlaps the next
                    # chunk's work on the card
                    outs[name].write(t, host)
            t += n
        closed = True
        for m in outs.values():
            m.flush() if writer == "memmap" else m.close()
    finally:
        if not closed and writer != "memmap":
            for m in outs.values():
                try:
                    m.close()
                except Exception:
                    pass  # the original error propagates
    return {name: os.path.join(out_dir, f"{name}.npy") for name in outs}
