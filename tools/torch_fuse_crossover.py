#!/usr/bin/env python3
"""The 3D step loop at 'default' through the fused kernels (K6-K8) and
through the plain GEMM route, side by side on the card: the reading that
sets `Spectral3DConfig.PALLAS_FUSE_CROSSOVER` (the 'auto' gate).

For each grid n^3 (default 128, 256, 384): the plain Taylor-Green step loop
at `--precision default` and, where the fused kernels fit shared memory,
the fused one, each through `ns_tpu_torch.cli.profile_run` (steps/s as the
median of 3 timed rollouts, the device idle share and the top kernels of a
profiled one), in turns plain, fused, fused, plain. Needs a CUDA device.
Prints one JSON line.

    python tools/torch_fuse_crossover.py [n ...]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ns_tpu_torch.cli import profile_run  # noqa: E402
from ns_tpu_torch.solvers import spectral3d as s3  # noqa: E402


def argv(n: int, fused: bool) -> list:
    return ["taylor_green_3d", "--nx", str(n), "--nt", "8", "--transform",
            "matmul", "--precision", "default", "--pallas-transform",
            "on" if fused else "off"]


def main(sizes):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = {"device": torch.cuda.get_device_name(0), "grids": {}}
    for n in sizes:
        cfg = s3.Spectral3DConfig(nx=n, ny=n, nz=n, transform="matmul",
                                  matmul_precision="default")
        routes = ([False, True, True, False] if cfg._fused_fits_smem()
                  else [False])
        row = {"fused_fits": len(routes) > 1, "plain": [], "fused": []}
        for fused in routes:
            r = profile_run.profile(argv(n, fused))
            key = "fused" if fused else "plain"
            row[key].append(r["steps_per_s_median_of_3"])
            row[key + "_idle_share"] = r["device_idle_share"]
            row[key + "_busy_ms"] = r["device_busy_ms"]
            row[key + "_top_device_ms"] = r["top_device_ms"][:4]
        out["grids"][str(n)] = row
    print(json.dumps(out))


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [128, 256, 384])
