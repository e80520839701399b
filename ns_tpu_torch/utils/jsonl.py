"""Host-side JSONL metrics logging: one JSON object a line, each with the
wall time it was written at.

A copy of `ns_tpu/utils/jsonl.py` (the port imports nothing of the JAX
package, whose `utils` package imports jax).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


def _jsonable(x):
    """Serializer fallback: arrays and tensors by `tolist`, scalars by
    float (a multi-element array under a plain `default=float` would raise
    from inside the logging call)."""
    if hasattr(x, "tolist"):
        return x.tolist()
    return float(x)


class JSONLLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, metrics: Mapping[str, Any], **extra):
        rec = {"time": time.time(), **metrics, **extra}
        self._f.write(json.dumps(rec, default=_jsonable) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
