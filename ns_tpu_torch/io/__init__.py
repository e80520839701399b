"""Rollout I/O of the port: `stream_rollout` streams a rollout to .npy
files a chunk at a time (io/streaming.py) through `AsyncNpyWriter`
(io/native_writer.py: the C++ ring writer, a Python thread or in-line
writes). The reference-format npz is written by cli/run_solver.py."""

from ns_tpu_torch.io.native_writer import AsyncNpyWriter
from ns_tpu_torch.io.streaming import stream_rollout

__all__ = ["AsyncNpyWriter", "stream_rollout"]
