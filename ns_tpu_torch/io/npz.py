"""Reference-compatible npz rollout interchange (a copy of
`ns_tpu/io/npz.py`, which the port may not import).

The reference's solvers dump rollouts as np.savez with keys u, v, p, each
(nt, nx, ny), and its training scripts load them back by those keys. The
canonical dataset file names are the reference's.
"""

from __future__ import annotations

import os

import numpy as np

# canonical file names (the reference's src/constants.py)
CHORIN_FD_DATA_FILE = "data_semi_implicit.npz"
DIRECT_FD_DATA_FILE = "data.npz"


def save_rollout(path: str, u, v, p) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    np.savez(path, u=np.asarray(u), v=np.asarray(v), p=np.asarray(p))
    return path


def load_rollout(path: str):
    data = np.load(path)
    return data["u"], data["v"], data["p"]
