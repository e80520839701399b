"""Rollout I/O of the port: the reference-format npz (`save_rollout`,
`load_rollout`, io/npz.py), block-mean coarsening (`spatial_coarsen`,
io/coarsen.py), and `stream_rollout`, which streams a rollout to .npy files
a chunk at a time (io/streaming.py) through `AsyncNpyWriter`
(io/native_writer.py: the C++ ring writer, a Python thread or in-line
writes)."""

from ns_tpu_torch.io.coarsen import spatial_coarsen
from ns_tpu_torch.io.native_writer import AsyncNpyWriter
from ns_tpu_torch.io.npz import load_rollout, save_rollout
from ns_tpu_torch.io.streaming import stream_rollout

__all__ = ["AsyncNpyWriter", "load_rollout", "save_rollout",
           "spatial_coarsen", "stream_rollout"]
