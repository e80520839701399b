"""Evaluate a trained surrogate against its data.

Port of `ns_tpu/cli/evaluate.py`. Given a checkpoint (or a saved
extrapolation file) and the observation npz, it reports relative-L2
errors over the train window, the extrapolation window and the full
horizon, per field, along the horizon, and against the persistence
baseline (frame 0 forever). Ensemble checkpoints are scored as the member
mean, with the member spread beside it. `--physics` adds the periodic
grid's observables: the time-mean energy-spectrum error and the max
spectral divergence of the prediction (2D, and 3D (u, v, w, p) data).

The checkpoint rollout and `--physics` run on the card unless given
`--device cpu` (without a card they exit with an error); scoring a saved
extrapolation without `--physics` is numpy only.

Examples:
  python -m ns_tpu_torch.cli.evaluate --ckpt checkpoints/fno_w_10 \\
      --npz-path data.npz --json report.json
  python -m ns_tpu_torch.cli.evaluate \\
      --extrapolation checkpoints/rnn_10/extrapolation.npy \\
      --npz-path data_semi_implicit.npz --offset 1
"""

import argparse
import json

import numpy as np

from ns_tpu_torch.train.metrics import rel_l2


def _window_metrics(pred: np.ndarray, obs: np.ndarray,
                    persist: np.ndarray) -> dict:
    return {
        "rel_l2": rel_l2(pred, obs),
        "persistence_rel_l2": rel_l2(persist, obs),
        "fields": {name: rel_l2(pred[:, i], obs[:, i])
                   for i, name in enumerate(
                       ("u", "v", "p") if pred.shape[1] == 3
                       else ("u", "v", "w", "p"))},
    }


def evaluate(pred: np.ndarray, obs: np.ndarray, n_train: int) -> dict:
    """pred, obs: frame-aligned (nt, 3, nx, ny), or (nt, 4, nx, ny, nz) for
    3D (u, v, w, p); n_train: frames the model was trained on (train window
    [0, n_train), extrapolation window [n_train, nt))."""
    nt = obs.shape[0]
    if pred.shape != obs.shape:
        raise ValueError(f"prediction shape {pred.shape} does not match "
                         f"observations {obs.shape}")
    if n_train < 1:
        raise ValueError(f"n_train must be >= 1, got {n_train} (an empty "
                         "train window would score NaN)")
    n_train = min(n_train, nt)
    persist = np.broadcast_to(obs[:1], obs.shape)
    report = {
        "n_frames": nt,
        "n_train": n_train,
        "windows": {
            "train": _window_metrics(pred[:n_train], obs[:n_train],
                                     persist[:n_train]),
            "full": _window_metrics(pred, obs, persist),
        },
    }
    if n_train < nt:
        report["windows"]["extrapolation"] = _window_metrics(
            pred[n_train:], obs[n_train:], persist[n_train:])
    # error along the horizon: quartile frames and the last one
    marks = sorted({max(1, nt // 4), nt // 2, 3 * nt // 4, nt - 1})
    report["horizon_curve"] = [
        {"frame": k, "rel_l2": rel_l2(pred[k], obs[k])} for k in marks
        if 0 < k < nt]
    return report


def physics_metrics(pred: np.ndarray, obs: np.ndarray, device=None) -> dict:
    """Physics observables on the 2*pi-periodic spectral grid (the
    decaying_turbulence / taylor_green data; meaningless for cavity FD
    rollouts): the time-mean isotropic energy-spectrum error and the max
    divergence of the predicted velocity (exact spectral definition),
    computed in the data's dtype on `device` (None: the card)."""
    import torch

    from ns_tpu_torch.core.device import resolve_device
    from ns_tpu_torch.solvers import spectral_periodic as sp

    device = resolve_device(device)
    nt, nx, ny = obs.shape[0], obs.shape[-2], obs.shape[-1]
    cfg = sp.SpectralPeriodicConfig(nx=nx, ny=ny)
    ops = sp.make_ops(cfg, device)

    def per_seq(seq):
        u, v = (torch.as_tensor(np.ascontiguousarray(seq[:, i]),
                                device=device) for i in (0, 1))
        u_hat, v_hat = torch.fft.rfft2(u), torch.fft.rfft2(v)
        w_hat = (sp._ik_mul(ops["kx"], v_hat)
                 - sp._ik_mul(ops["ky"], u_hat))
        # energy_spectrum bins every frame of the batch into one spectrum:
        # the sum over the frames, so /nt is the time mean
        spec = sp.energy_spectrum(cfg, w_hat)[1] / nt
        div = sp.irfft2(sp._ik_mul(ops["kx"], u_hat)
                        + sp._ik_mul(ops["ky"], v_hat), (nx, ny))
        return spec.cpu().numpy(), float(div.abs().max())

    spec_p, div_p = per_seq(pred)
    spec_o, div_o = per_seq(obs)
    return {
        "spectrum_rel_l2": float(np.linalg.norm(spec_p - spec_o)
                                 / np.linalg.norm(spec_o)),
        "divergence_max_pred": div_p,
        "divergence_max_obs": div_o,
    }


def physics_metrics3d(pred: np.ndarray, obs: np.ndarray,
                      device=None) -> dict:
    """The 3D counterpart of `physics_metrics` on (nt, 4, nx, ny, nz)
    (u, v, w, p) rollouts: the time-mean shell-binned energy-spectrum error
    and the max spectral divergence of the predicted velocity (the 3D
    solver's diagnostics, float32 as the JAX package's), on `device`
    (None: the card)."""
    import torch

    from ns_tpu_torch.core.device import resolve_device
    from ns_tpu_torch.solvers import spectral3d as s3

    device = resolve_device(device)
    nt, (nx, ny, nz) = obs.shape[0], obs.shape[-3:]
    cfg = s3.Spectral3DConfig(nx=nx, ny=ny, nz=nz)

    def per_seq(seq):
        vel = torch.as_tensor(np.ascontiguousarray(seq[:, :3]), device=device)
        u_hat = torch.fft.rfftn(vel, dim=(-3, -2, -1))   # (nt, 3, ...)
        # energy_spectrum sums its first axis: every component of every
        # frame into one spectrum, so /nt is the time mean
        spec = s3.energy_spectrum(cfg, u_hat.flatten(0, 1))[1] / nt
        div = s3.divergence_max(cfg, u_hat.transpose(0, 1))
        return spec.cpu().numpy(), float(div)

    spec_p, div_p = per_seq(pred)
    spec_o, div_o = per_seq(obs)
    return {
        "spectrum_rel_l2": float(np.linalg.norm(spec_p - spec_o)
                                 / np.linalg.norm(spec_o)),
        "divergence_max_pred": div_p,
        "divergence_max_obs": div_o,
    }


def _print_report(report: dict) -> None:
    print(f"frames: {report['n_frames']} (train window "
          f"{report['n_train']})")
    field_names = list(next(iter(
        report["windows"].values()))["fields"])  # (u,v,p) or (u,v,w,p)
    print(f"| window | rel L2 | persistence | {' | '.join(field_names)} |")
    print("|---" * (3 + len(field_names)) + "|")
    for name, w in report["windows"].items():
        cells = " | ".join(f"{w['fields'][k]:.4f}" for k in field_names)
        print(f"| {name} | {w['rel_l2']:.4f} | "
              f"{w['persistence_rel_l2']:.4f} | {cells} |")
    curve = " -> ".join(f"{m['rel_l2']:.3f}@{m['frame']}"
                        for m in report["horizon_curve"])
    print(f"horizon: {curve}")
    if "physics" in report:
        ph = report["physics"]
        print(f"physics (periodic): spectrum rel L2 "
              f"{ph['spectrum_rel_l2']:.4f}, max|div u| pred "
              f"{ph['divergence_max_pred']:.2e} (obs "
              f"{ph['divergence_max_obs']:.2e})")
    if "ensemble" in report:
        e = report["ensemble"]
        print(f"ensemble: {e['n_models']} members, mean-rollout rel L2 "
              f"{report['windows']['full']['rel_l2']:.4f}, member spread "
              f"(mean per-cell std) {e['member_spread']:.4f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt",
                     help="checkpoint.npz or its directory: rolls the "
                          "model out from the data's frame 0 (ensemble "
                          "checkpoints evaluate the member mean)")
    src.add_argument("--extrapolation",
                     help="a saved extrapolation .npy (nt, 3, nx, ny)")
    p.add_argument("--npz-path", required=True,
                   help="observation rollout (u, v, p arrays)")
    p.add_argument("--n-frames", type=int, default=100,
                   help="train-window length used at training time "
                        "(default: the reference's 100; --ckpt mode reads "
                        "the checkpoint's own value instead)")
    p.add_argument("--offset", type=int, default=0,
                   help="prediction-frame offset: pred[t] ~ obs[t+offset] "
                        "(the reference rnn convention needs 1; engine "
                        "outputs are frame-aligned at 0)")
    p.add_argument("--chunk", type=int, default=64,
                   help="ckpt mode: rollout chunk length")
    p.add_argument("--traj", type=int, default=0,
                   help="multi-trajectory datasets (run_solver --n-traj): "
                        "which trajectory to score against")
    p.add_argument("--physics", action="store_true",
                   help="add periodic-grid physics observables: time-mean "
                        "energy-spectrum error and exact spectral "
                        "divergence of the prediction (2*pi-periodic "
                        "data only, 2D and 3D)")
    p.add_argument("--json", default=None,
                   help="also write the full report as JSON here")
    p.add_argument("--device", default="cuda",
                   help="where --ckpt rolls out and --physics computes "
                        "(default cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    with np.load(args.npz_path) as d:
        is_3d = "w" in d  # run_solver *_3d rollouts carry (u, v, w, p)
        names = ("u", "v", "w", "p") if is_3d else ("u", "v", "p")
        fields = [d[k] for k in names]
    if fields[0].ndim == 4 + is_3d:  # multi-trajectory dataset
        if not 0 <= args.traj < fields[0].shape[0]:
            raise SystemExit(f"--traj must be in [0, "
                             f"{fields[0].shape[0]}), got {args.traj}")
        fields = [f[args.traj] for f in fields]
    obs = np.stack(fields, axis=1).astype(np.float32)
    nt = obs.shape[0]
    n_train = args.n_frames

    device = None
    if args.ckpt or args.physics:
        from ns_tpu_torch.core.device import resolve_device
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            p.error(str(e))

    ensemble = None
    if args.ckpt:
        if args.offset:
            raise SystemExit("--offset applies only to saved extrapolation "
                             "files; engine predictions are always frame-"
                             "aligned (pred[t] ~ obs[t])")
        from ns_tpu_torch.serve.engine import InferenceEngine
        eng = InferenceEngine.from_checkpoint(args.ckpt, chunk=args.chunk,
                                              device=device)
        n_train = int(eng.cfg.n_frames or n_train)
        pred = eng.predict(obs[0], nt - 1)     # frame-aligned, echo at 0
        if eng.n_models > 1:
            ensemble = {"n_models": eng.n_models,
                        "member_spread": float(pred.std(axis=0).mean())}
            pred = pred.mean(axis=0)
    else:
        pred = np.load(args.extrapolation).astype(np.float32)
        if pred.ndim != (5 if is_3d else 4):
            raise ValueError(f"extrapolation rank does not match the "
                             f"observations; got {pred.shape} for "
                             f"{'3D' if is_3d else '2D'} data")

    if not 0 <= args.offset < nt:
        raise SystemExit(f"--offset must be in [0, {nt}), got {args.offset}")
    if args.offset >= n_train:
        raise SystemExit(f"--offset must be < the train window "
                         f"(n_frames={n_train}), got {args.offset}")
    if args.offset:
        pred, obs = pred[:nt - args.offset], obs[args.offset:]
        # pred index t now scores obs frame t + offset, which was trained
        # on iff t + offset < n_train
        n_train -= args.offset

    report = evaluate(pred, obs, n_train)
    report["source"] = args.ckpt or args.extrapolation
    report["npz_path"] = args.npz_path
    if ensemble:
        report["ensemble"] = ensemble
    if args.physics:
        report["physics"] = (physics_metrics3d if is_3d else
                             physics_metrics)(pred, obs, device)
    _print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.json}")
    return report


if __name__ == "__main__":
    main()
