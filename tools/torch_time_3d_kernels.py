#!/usr/bin/env python3
"""Time the 3D transform kernels K6-K8 on the card as chip_smoke.py's
phase 3 does (256^3 and 40x36x30 checked against their twins at 'default'
and 'highest', then timed at 256^3 in turns beside their twins and, for
K6 and K7, one cuFFT call), without the other phases. Needs a CUDA device.
Prints one JSON line with each kernel's times and bounds.

    python tools/torch_time_3d_kernels.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    res = chip_smoke.Results()
    chip_smoke.phase_kernels_3d(res, torch.device("cuda"))
    print(json.dumps({name: dict(ms=res.ms[name], plain_ms=res.plain_ms[name],
                                 bound_ms=res.bound[name][0],
                                 library_ms=res.library_ms.get(name),
                                 **res.extra[name])
                      for name in res.extra}))


if __name__ == "__main__":
    main()
