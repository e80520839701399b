"""Spatial block-mean coarsening of rollouts (a numpy copy of
`ns_tpu/io/coarsen.py`).

Block-average (T, nx, ny) u/v/p rollouts by agg_x x agg_y and return new
meshgrids on [0, 2], as the reference's spatial_coarsen does, with its
double loop as one reshape-mean.

Reference quirk: its j-loop bound reuses agg_x (`range(ny // agg_x)`), so
for agg_x != agg_y the output misses or repeats columns. quirk_compat=True
(the default, as everywhere in the repo) replicates that; quirk_compat=False
fixes it. The quirk is a no-op when agg_x == agg_y (the reference's only
usage).
"""

from __future__ import annotations

import numpy as np


def spatial_coarsen(X, Y, u_seq, v_seq, p_seq, agg_x: int = 4,
                    agg_y: int = 4, quirk_compat: bool = True):
    nx, ny = X.shape[0], X.shape[1]
    T = u_seq.shape[0]
    assert nx % agg_x == 0
    assert ny % agg_y == 0

    out_x = nx // agg_x
    out_y = ny // agg_y

    def block_mean(seq):
        r = np.asarray(seq).reshape(T, out_x, agg_x, out_y, agg_y)
        return r.mean(axis=(2, 4))

    new_u, new_v, new_p = block_mean(u_seq), block_mean(v_seq), block_mean(p_seq)

    if quirk_compat and agg_x != agg_y:
        # the reference's j-range bug: for agg_x > agg_y only the first
        # ny // agg_x columns are written (the rest stay zero); for
        # agg_x < agg_y the reference itself raises IndexError (j*agg_y
        # walks past ny), so there is no behaviour to replicate: refuse
        if agg_x < agg_y:
            raise IndexError(
                "quirk_compat spatial_coarsen with agg_x < agg_y: the "
                "reference raises IndexError here (its j-range bug); use "
                "quirk_compat=False for the corrected block mean")
        j_cap = ny // agg_x
        for arr in (new_u, new_v, new_p):
            if j_cap < out_y:
                arr[:, :, j_cap:] = 0.0

    new_x = np.linspace(0, 2, out_x)
    new_y = np.linspace(0, 2, out_y)
    new_X, new_Y = np.meshgrid(new_x, new_y)
    return new_X, new_Y, new_u, new_v, new_p
