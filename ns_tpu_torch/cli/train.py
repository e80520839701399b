"""Train a surrogate model: one CLI for every family, 2D and 3D.

Port of `ns_tpu/cli/train.py`, with every flag of the JAX CLI: the
reference's (--npz-path --out-dir --n-iters --n-coeffs --gpu-device; the
output directory gets the _{n_coeffs} suffix), --model, --resume and the
operator families' and schedule's knobs, plus --device. Training runs on
the card unless given --device cpu (without a card the command exits with
an error); --gpu-device is accepted and ignored. --n-models > 1 trains an
ensemble, its members sharded over an 'ensemble' mesh of the process
group's ranks with --mesh auto (`train/ensemble.py::ensemble_mesh`; one
rank: every member on it). --dist joins the process group from the
NS_TPU_* variables that `python -m ns_tpu_torch.launch` sets, and then
trains data-parallel over a {'data': world} mesh, at a world of 1 too;
--dp (the mesh's size) must equal the world size (one device a rank).
The coordinator writes checkpoint.npz (+ .meta.json) every --ckpt-every
iterations, metrics.jsonl, and extrapolation.npy at the end.

Examples:
  python -m ns_tpu_torch.cli.train --model basis_ode \\
      --npz-path data_semi_implicit.npz
  python -m ns_tpu_torch.cli.train --model fno_w --npz-path turb.npz \\
      --fno-width 64 --fno-modes 43 --n-iters 200 --device cpu
  python -m ns_tpu_torch.cli.train --model fno3d_a --npz-path turb3d.npz \
      --fno-width 24 --fno-modes 16 --fno-rollout-steps 4 --fno-remat \
      --batch-size 4 --lr-schedule cosine --warmup-iters 100 --grad-clip 1
  python -m ns_tpu_torch.launch --nprocs 2 --platform cpu -- \
      python -m ns_tpu_torch.cli.train --model fno_w --npz-path turb.npz \
      --dist --dp 2 --device cpu
"""

import argparse
import os

import numpy as np

import torch

from ns_tpu_torch.core.device import resolve_device
from ns_tpu_torch.parallel import distributed
from ns_tpu_torch.train.trainer import (MODELS, TrainConfig, Trainer,
                                        make_dp_mesh)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", type=str, default="basis_ode", choices=MODELS)
    p.add_argument("--npz-path", type=str, default="./data_semi_implicit.npz")
    p.add_argument("--out-dir", type=str, default=None,
                   help="default: ./checkpoints/<model>")
    p.add_argument("--n-iters", type=int, default=1000)
    p.add_argument("--n-coeffs", type=int, default=10)
    p.add_argument("--n-frames", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--hidden-dim", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-every", type=int, default=10,
                   help="checkpoint interval; also the train chunk size "
                        "(one host read of the losses a chunk)")
    p.add_argument("--fno-rollout-steps", type=int, default=1,
                   help="fno families: k-step rollout training (pushforward)")
    p.add_argument("--fno-modes", type=int, default=12,
                   help="fno families: spectral modes kept per axis")
    p.add_argument("--fno-width", type=int, default=32,
                   help="fno families: channel width")
    p.add_argument("--fno-transform", default="auto",
                   choices=["auto", "fft", "matmul"],
                   help="fno families: spectral-transform engine (engines "
                        "agree to fp rounding)")
    p.add_argument("--fno-precision", default=None,
                   choices=["default", "high", "highest"],
                   help="fno families: GEMM precision in the spectral "
                        "layers (default: fp32 with TF32 off; 'default' "
                        "is bf16 inputs with fp32 sums, backward too)")
    p.add_argument("--input-noise", type=float, default=0.0,
                   help="fno families: train-time Gaussian input noise, as a "
                        "fraction of the data std; 0 disables")
    p.add_argument("--fno-remat", action="store_true",
                   help="fno families: rematerialize each k-step unroll step "
                        "in the backward pass")
    p.add_argument("--fno-project", action="store_true",
                   help="fno/fno3d: compose the exact spectral divergence "
                        "(2D) / Leray (3D) projection into the "
                        "autoregressive rollout")
    p.add_argument("--no-fno-dealias", action="store_true",
                   help="fno_w/fno_psi/fno3d: disable the 2/3-band rollout "
                        "filter")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint.npz to continue (the JAX package's too)")
    p.add_argument("--n-models", type=int, default=1,
                   help=">1 trains an ensemble of independently drawn models")
    p.add_argument("--mesh", type=str, default="auto",
                   choices=["auto", "none"],
                   help="ensemble mesh: 'auto' (the largest usable rank "
                        "count), 'none' (every member on this rank); only "
                        "with --n-models > 1")
    p.add_argument("--batch-size", type=int, default=0,
                   help="fno families: sample this many training windows "
                        "per step (with replacement); 0 = full batch")
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine"],
                   help="learning-rate schedule (resume continues it)")
    p.add_argument("--warmup-iters", type=int, default=0,
                   help="linear 0 -> lr warmup iterations")
    p.add_argument("--schedule-horizon", type=int, default=None,
                   help="total iterations the schedule decays over "
                        "(default: this run's --n-iters)")
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="global-norm gradient clip (0 disables)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel devices for single-model training "
                        "(fno families shard the training windows, rnn the "
                        "trajectories; params replicated, gradients "
                        "all-reduced); one rank a device, so it equals the "
                        "--dist world size; not with --n-models > 1")
    p.add_argument("--dist", action="store_true",
                   help="join the process group from the NS_TPU_* "
                        "variables (python -m ns_tpu_torch.launch sets "
                        "them) and train over its ranks")
    p.add_argument("--gpu-device", type=int, default=0,
                   help="accepted for reference-CLI compatibility; ignored")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; a machine without a "
                        "card needs --device cpu)")
    args = p.parse_args(argv)
    if args.dp > 1 and args.n_models > 1:
        p.error("--dp shards single-model training; --n-models > 1 "
                "ensembles shard the 'ensemble' axis instead (use --mesh)")
    if args.dist:
        if not ("NS_TPU_COORDINATOR" in os.environ
                or "MASTER_ADDR" in os.environ):
            p.error("--dist needs a process group: run under `python -m "
                    "ns_tpu_torch.launch --nprocs N [--platform cpu] -- "
                    "python -m ns_tpu_torch.cli.train ... --dist`")
        platform = os.environ.get("NS_TPU_PLATFORM") or torch.device(
            args.device).type
        device = distributed.initialize(platform=platform)
    else:
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            p.error(str(e))

    out_dir = args.out_dir or f"./checkpoints/{args.model}"
    out_dir = f"{out_dir}_{args.n_coeffs}"  # the reference's suffix
    cfg = TrainConfig(model=args.model, npz_path=args.npz_path,
                      out_dir=out_dir, n_iters=args.n_iters,
                      n_coeffs=args.n_coeffs, lr=args.lr,
                      hidden_dim=args.hidden_dim, n_frames=args.n_frames,
                      seed=args.seed, ckpt_every=args.ckpt_every,
                      fno_rollout_steps=args.fno_rollout_steps,
                      fno_transform=args.fno_transform,
                      fno_precision=args.fno_precision,
                      fno_modes=args.fno_modes, fno_width=args.fno_width,
                      fno_project=args.fno_project,
                      input_noise=args.input_noise,
                      fno_remat=args.fno_remat,
                      fno_dealias=not args.no_fno_dealias,
                      resume=args.resume, dp=args.dp,
                      lr_schedule=args.lr_schedule,
                      warmup_iters=args.warmup_iters,
                      schedule_horizon=args.schedule_horizon,
                      grad_clip=args.grad_clip,
                      batch_size=args.batch_size)
    if args.n_models > 1:
        from ns_tpu_torch.train.ensemble import EnsembleTrainer
        tr = EnsembleTrainer(cfg, args.n_models,
                             mesh="auto" if args.mesh == "auto" else None,
                             device=device)
    else:
        # under --dist the data mesh spans the world, a world of 1 too
        tr = Trainer(cfg, device=device,
                     mesh=make_dp_mesh(cfg) if args.dist else None)
    tr.train()
    if distributed.is_coordinator():
        # the state is replicated (or gathered): one writer
        extrap = tr.extrapolate()
        out = os.path.join(out_dir, "extrapolation.npy")
        np.save(out, extrap)
        print(f"saved {out} shape={extrap.shape}")
    if args.dist:
        distributed.barrier("train_done")
        distributed.shutdown()
    return tr


if __name__ == "__main__":
    main()
