#!/usr/bin/env python3
"""sha256 digests of the 3D transform kernels' outputs on fixed inputs, on
the card: K6, K7 and K8 at 'default' (their bf16 tensor-core kernels) and
at 'highest' (their 3xTF32 kernels), at the main path's 256^3 and at
ragged grids. Two trees built and run on one card give equal digests
where a kernel kept its bits. `tests/test_torch_cuda.py` holds a parent tree's
digests.

    python tools/torch_kernel_digests.py    # one JSON line: case -> digest

It uses only the public wrappers, so it runs in an older tree too (copy it
there and run it with that tree's package).
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ns_tpu_torch.ops import kernels  # noqa: E402
from ns_tpu_torch.solvers import spectral3d as s3  # noqa: E402

GRIDS = {"fused_zy_forward": [(256, 256, 256), (40, 36, 30), (8, 300, 30)],
         "fused_yz_inverse": [(256, 256, 256), (40, 36, 30), (24, 70, 20)],
         "fused_lamb": [(256, 256, 256), (40, 36, 30), (24, 70, 20)]}
# (wrapper, precision, grid) -> "name precision nx ny nz"
CASES = [f"{name} {p} {' '.join(map(str, grid))}"
         for name, grids in GRIDS.items()
         for p in ("default", "highest")
         for grid in grids]


def _randn(shape, seed, complex_=False):
    gen = torch.Generator().manual_seed(seed)
    if complex_:
        return torch.view_as_complex(torch.randn((*shape, 2), generator=gen))
    return torch.randn(shape, generator=gen)


def output(case: str, device) -> torch.Tensor:
    """The wrapper's output for `case` on fixed inputs (seeded on the
    CPU, then copied to `device`)."""
    name, p, *grid = case.split()
    nx, ny, nz = map(int, grid)
    cfg = s3.Spectral3DConfig(nx=nx, ny=ny, nz=nz, transform="matmul")
    _, rows_y, kzc = s3._compact_meta(cfg)
    M = s3._dft_constants_np(cfg)
    ry = len(rows_y)
    if name == "fused_zy_forward":
        w = _randn((3, nx, ny, nz), 1).to(device)
        return kernels.fused_zy_forward(w, M["Fz_t"], M["Fy_t"], p)
    if name == "fused_yz_inverse":
        a = _randn((1, nx, ry, kzc), 2, True).to(device)
        return kernels.fused_yz_inverse(a, M["Fyi_t"], M["Bz"], nz, p)
    a6 = _randn((6, nx, ry, kzc), 3, True).to(device)
    return kernels.fused_lamb(a6, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"],
                              nz, p)


def digest(case: str, device) -> str:
    out = output(case, device)
    torch.cuda.synchronize()
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    print(json.dumps({case: digest(case, dev) for case in CASES}))


if __name__ == "__main__":
    main()
