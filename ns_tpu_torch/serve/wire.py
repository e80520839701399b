"""The serving wire format, shared by server and client: raw `.npy`
bytes (np.save/np.load on a buffer, allow_pickle always off). One
definition so the two sides can never drift.

A copy of `ns_tpu/serve/wire.py`: importing that module runs
`ns_tpu/serve/__init__.py`, which imports jax."""

from __future__ import annotations

import io

import numpy as np


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def npy_parse(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw), allow_pickle=False)
