#!/usr/bin/env python3
"""The forms of the port's float32 'high' GEMM on the card, side by side:
TF32 (what `ns_tpu_torch/ops/gemm.py` ran before), bf16x3 (the TPU's HIGH:
three bf16 GEMMs of the split inputs, fp32 output, summed smallest first)
and fp32 with TF32 off (gemm.py's form, the same as 'highest').

For each form: its error on a 256x256 @ 256x172 product (seed 0) as a
share of max|out| against the float64 product of the fp32 inputs; how far
the plain 256^3 Taylor-Green state after 8 steps at 'high' lies from the
same run at 'highest' (chip_smoke.py's phase-5 reading: u, v, w relative
to the largest velocity, p to its own max); and the step rate of a plain
3D run at 'high' through `ns_tpu_torch.cli.profile_run` (median of 3),
the forms taken in turns (f1 f2 f3 f3 f2 f1). Needs a CUDA device. Prints
one JSON line.

    python tools/torch_gemm_high_forms.py [profile_run argv ...]

The default argv is the plain 256^3 Taylor-Green step loop at 'high'.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import numpy as np  # noqa: E402

from ns_tpu_torch.cli import profile_run, run_solver  # noqa: E402
from ns_tpu_torch.ops import gemm  # noqa: E402

ARGV = ["taylor_green_3d", "--nx", "256", "--nt", "8", "--transform",
        "matmul", "--precision", "high", "--pallas-transform", "off"]


MATMUL = gemm.matmul  # gemm.py's own: 'high' is fp32 with TF32 off


def tf32(a, b):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def split_bf16(x):
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def bf16x3(a, b):
    (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
    mm = gemm._bf16_mm_f32
    return (mm(al, bh) + mm(ah, bl)) + mm(ah, bh)


FORMS = {"tf32": tf32, "bf16x3": bf16x3,
         "fp32": lambda a, b: MATMUL(a, b, "high")}


def use(form):
    """Route gemm.matmul's float32 'high' products (and with it cmatmul's
    and every caller's) through `form`."""
    gemm.matmul = lambda a, b, p: (form(a, b) if p == "high"
                                   and a.dtype == torch.float32
                                   else MATMUL(a, b, p))


def error(form) -> float:
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((256, 256), generator=gen).cuda()
    b = torch.randn((256, 172), generator=gen).cuda()
    use(form)
    got = gemm.matmul(a, b, "high").double()
    want = a.double() @ b.double()
    return float((got - want).abs().max() / want.abs().max())


def tg_state(precision: str, tmp: str) -> dict:
    """u, v, w, p of the plain 256^3 Taylor-Green run after 8 steps."""
    out = os.path.join(tmp, f"tg_{precision}.npz")
    run_solver.main(["taylor_green_3d", "--nx", "256", "--nt", "1",
                     "--spinup", "7", "--transform", "matmul",
                     "--precision", precision, "--pallas-transform", "off",
                     "--device", "cuda", "--out", out])
    d = np.load(out)
    return {k: d[k][-1] for k in "uvwp"}


def fidelity(form, highest: dict, tmp: str) -> dict:
    use(form)
    high = tg_state("high", tmp)
    vmax = max(float(np.abs(highest[k]).max()) for k in "uvw")
    return {k: float(np.abs(high[k] - highest[k]).max())
            / (float(np.abs(highest[k]).max()) if k == "p" else vmax)
            for k in "uvwp"}


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    names = list(FORMS)
    out = {"device": torch.cuda.get_device_name(0), "argv": argv,
           "max_rel_err": {n: error(FORMS[n]) for n in names},
           "steps_per_s": {n: [] for n in names}}
    with tempfile.TemporaryDirectory() as tmp:
        use(FORMS["fp32"])
        highest = tg_state("highest", tmp)
        out["tg256_high_vs_highest"] = {n: fidelity(FORMS[n], highest, tmp)
                                        for n in names}
    for name in names + names[::-1]:
        use(FORMS[name])
        r = profile_run.profile(argv)
        out["steps_per_s"][name].append(r["steps_per_s_median_of_3"])
        out.setdefault("top_device_ms", {})[name] = r["top_device_ms"][:3]
    gemm.matmul = MATMUL
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:] or ARGV)
