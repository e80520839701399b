"""A dense layer's weight gradient on the card: the forms of the batch sum.

`ops/gemm.py::_Product` computes the weight gradient of `Dense.channels`,
sum over the batch b of g_b @ h_b^T with g_b (m, K) and h_b (n, K), K the
grid's points. This script times the forms of that sum on an NVIDIA GPU,
in turns (each form once per round, the order reversed every other
round), and prints one JSON line with the card's name and power limit:

  uncut   one batched product of the nb (m, n) tiles, summed after;
  L<len>  K cut into pieces of <len>, one batched product of the nb * K /
          <len> tiles, summed after;
  flat    one product (m, nb K) @ (nb K, n) over copies of both operands;
  rule    ops/gemm.py::_batch_contract as the tree has it.

--products times the forms alone at the weight gradients of fno_w at 128^2
(width 64, the full batch of 99 windows), fno3d_a at 64^3 (width 24,
batch 4), and larger and smaller batches. --train fno_w | fno3d_a times
training iterations of those configurations (random data from a seed:
the speed does not depend on it) with each form installed in turn, or,
with --as-is, the tree's own backward only, so that a parent checkout's
rate can be read beside it (run with --tree <checkout>).

    python tools/torch_weight_grad.py --products [--reps 20]
    python tools/torch_weight_grad.py --train fno_w [--as-is] [--tree DIR]
        [--chunk 10] [--rounds 3]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# (label, nb, m, n, K): m, n of Dense.channels' weight gradient w^T (out,
# in); K the grid's points
SHAPES = [
    ("fno_w 128^2 w64 99 windows: bypass", 99, 64, 64, 128 * 128),
    ("fno_w 128^2 w64 99 windows: lift", 99, 64, 3, 128 * 128),
    ("fno_w 128^2 w64 99 windows: proj", 99, 1, 64, 128 * 128),
    ("fno_w 128^2 w64 batch 8: bypass", 8, 64, 64, 128 * 128),
    ("fno_w 128^2 w64 256 windows: bypass", 256, 64, 64, 128 * 128),
    ("fno_w 64^2 w64 199 windows: bypass", 199, 64, 64, 64 * 64),
    ("fno3d_a 64^3 w24 batch 4: bypass", 4, 24, 24, 64 ** 3),
    ("fno3d_a 64^3 w24 batch 4: lift", 4, 24, 6, 64 ** 3),
    ("fno3d_a 64^3 w24 batch 4: proj", 4, 3, 24, 64 ** 3),
    ("fno3d_a 64^3 w24 batch 32: bypass", 32, 24, 24, 64 ** 3),
    ("fno3d_a 32^3 w24 batch 4: bypass", 4, 24, 24, 32 ** 3),
]
PIECES = (16384, 4096, 1024)


def _root(tree):
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, os.path.abspath(tree or here))


def forms(gemm, as_is: bool) -> dict:
    """name -> f(product, x, y), the sum over the batch of x @ y for x
    (..., m, K), y (..., K, n)."""
    if as_is:
        return {"as-is": None}

    def uncut(product, x, y):
        return product(x, y).sum_to_size(x.shape[-2], y.shape[-1])

    def pieces(L):
        def f(product, x, y):
            m, K = x.shape[-2:]
            nb, n = x.numel() // (m * K), y.shape[-1]
            if K % L or L >= K:
                return uncut(product, x, y)
            x4 = x.reshape(nb, m, K // L, L).transpose(1, 2)
            y4 = y.reshape(nb, K // L, L, n)
            return product(x4, y4).sum((0, 1))
        return f

    def flat(product, x, y):
        m, K = x.shape[-2:]
        n = y.shape[-1]
        xs = x.reshape(-1, m, K).transpose(0, 1).reshape(m, -1)
        return product(xs, y.reshape(-1, n))

    out = {"uncut": uncut, "flat": flat}
    out.update({f"L{L}": pieces(L) for L in PIECES})
    if hasattr(gemm, "_batch_contract"):
        out["rule"] = gemm._batch_contract
    return out


def in_turns(fns: dict, rounds: int) -> dict:
    """name -> list of seconds, each fn() called once a round, the order
    reversed every other round."""
    import torch

    names, out = list(fns), {k: [] for k in fns}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            out[k].append(time.perf_counter() - t0)
    return out


def products(gemm, reps: int) -> list:
    import torch

    product = gemm._fp32_product
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, nb, m, n, K in SHAPES:
        g = torch.randn(nb, m, K, device="cuda", generator=gen)
        h = torch.randn(nb, n, K, device="cuda", generator=gen)
        fs = forms(gemm, False)
        want = (g.double() @ h.double().mT).sum(0)
        errs = {k: float((f(product, g, h.mT).double() - want)
                         .abs().max() / want.abs().max())
                for k, f in fs.items()}
        calls = {k: (lambda f=f: [f(product, g, h.mT)
                                  for _ in range(reps)])
                 for k, f in fs.items()}
        in_turns(calls, 2)  # warm-up: cuBLAS heuristics and workspaces
        t = in_turns(calls, 4)
        ms = {k: statistics.median(v) / reps * 1e3 for k, v in t.items()}
        # bound: each operand read once (fp32 bytes) at 3.35 TB/s
        bound = 4 * nb * K * (m + n) / 3.35e12 * 1e3
        rows.append({"shape": label, "nb": nb, "m": m, "n": n, "K": K,
                     "ms": ms, "best": min(ms, key=ms.get),
                     "bytes_bound_ms": bound, "rel_err": errs})
        del g, h, want
        torch.cuda.empty_cache()
    return rows


def _data(model: str, tmp: str) -> str:
    """Random frames of the configuration's grid, from a numpy seed."""
    rng = np.random.default_rng(0)
    if model == "fno_w":
        shape, keys = (100, 128, 128), "uvp"
    else:
        shape, keys = (40, 64, 64, 64), "uvwp"
    path = os.path.join(tmp, f"{model}.npz")
    np.savez(path, **{k: rng.standard_normal(shape).astype(np.float32)
                      for k in keys})
    return path


def train(gemm, model: str, as_is: bool, chunk: int, rounds: int) -> dict:
    import torch

    from ns_tpu_torch.train.trainer import Trainer, TrainConfig

    tmp = tempfile.mkdtemp()
    npz = _data(model, tmp)
    if model == "fno_w":  # chip_smoke.py's fno_w training cell
        cfg = TrainConfig(model="fno_w", npz_path=npz, out_dir=tmp,
                          fno_width=64, fno_modes=43, n_frames=100)
    else:  # chip_smoke.py's fno3d_a training cell
        cfg = TrainConfig(model="fno3d_a", npz_path=npz, out_dir=tmp,
                          fno_width=24, fno_modes=16, n_frames=40,
                          fno_rollout_steps=4, fno_remat=True, batch_size=4,
                          lr=1e-3, lr_schedule="cosine", warmup_iters=100,
                          schedule_horizon=1500, grad_clip=1.0)
    tr = Trainer(cfg, device="cuda")
    own = getattr(gemm, "_batch_contract", None)
    fs = forms(gemm, as_is)

    def run(f):
        def call():
            if f is not None:
                gemm._batch_contract = f
            try:
                tr.train_chunk(chunk)
            finally:
                if own is not None:
                    gemm._batch_contract = own
        return call

    calls = {k: run(f) for k, f in fs.items()}
    in_turns(calls, 1)  # warm-up
    t = in_turns(calls, rounds)
    return {"model": model, "chunk": chunk,
            "it_per_s": {k: [chunk / s for s in v] for k, v in t.items()},
            "it_per_s_median": {k: chunk / statistics.median(v)
                                for k, v in t.items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--products", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train", choices=("fno_w", "fno3d_a"))
    ap.add_argument("--as-is", action="store_true")
    ap.add_argument("--tree", default=None,
                    help="the checkout whose ns_tpu_torch to import")
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    _root(args.tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_weight_grad needs a CUDA device")
    from ns_tpu_torch.ops import gemm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"card": smi.stdout.strip(), "tree": os.path.abspath(
        os.path.dirname(os.path.dirname(gemm.__file__)))}
    if args.products:
        out["products"] = products(gemm, args.reps)
    if args.train:
        out["train"] = train(gemm, args.train, args.as_is, args.chunk,
                             args.rounds)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
