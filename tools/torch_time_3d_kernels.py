#!/usr/bin/env python3
"""Time the 3D transform kernels K6-K8 on the card as chip_smoke.py's
phase 3 does (256^3 and 40x36x30 checked against their twins at 'default'
and 'highest', then timed at 256^3 in turns beside their twins and, for
K6 and K7, one cuFFT call, for K8 a composite of cuFFT calls where the
tree's phase 3 has it), without the other phases; then K8's device time
by kernel at 256^3 at each precision (the profiler's records of one
call), and chip_smoke.py's 256^3 Taylor-Green step rates at 'high',
fused beside plain (`tg3d_high`). Needs a CUDA device. Prints one JSON
line with each kernel's times and bounds.

    python tools/torch_time_3d_kernels.py

It uses chip_smoke.py's phases and the public wrappers only, so it runs
in an older tree too (copy it there and run it with that tree's
package).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def k8_kernels_ms(dev) -> dict:
    """K8's device ms by kernel name in one call at 256^3, each precision
    (runtime/engine.py::_device_records)."""
    from ns_tpu_torch.ops import kernels
    from ns_tpu_torch.runtime.engine import _device_records
    from ns_tpu_torch.solvers import spectral3d as s3

    n = chip_smoke.N3D
    cfg = s3.Spectral3DConfig(nx=n, ny=n, nz=n, transform="matmul")
    _, rows_y, kzc = s3._compact_meta(cfg)
    M = s3._dft_tables(cfg, dev)
    gen = torch.Generator().manual_seed(5)
    a6 = torch.view_as_complex(torch.randn((6, n, len(rows_y), kzc, 2),
                                           generator=gen)).to(dev)
    out = {}
    for p in ("default", "highest"):
        ms = {}
        for name, us in _device_records(lambda: kernels.fused_lamb(
                a6, M["Fyi_t"], M["Bz"], M["Fz_t"], M["Fy_t"], n, p), dev):
            if name != "measured":  # the profiler's window, not a kernel
                ms[name] = ms.get(name, 0.0) + us / 1e3
        out[p] = ms
    return out


def main():
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    res = chip_smoke.Results()
    dev = torch.device("cuda")
    chip_smoke.phase_kernels_3d(res, dev)
    line = {name: dict(ms=res.ms[name], plain_ms=res.plain_ms[name],
                       bound_ms=res.bound[name][0],
                       library_ms=res.library_ms.get(name),
                       **res.extra[name])
            for name in res.extra}
    line["fused_lamb"]["kernels_ms"] = k8_kernels_ms(dev)
    line["tg3d_high"] = chip_smoke.tg3d_high_rates()
    print(json.dumps(line))


if __name__ == "__main__":
    main()
