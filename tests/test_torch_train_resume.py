"""The port's Trainer and EnsembleTrainer against ns_tpu's across both
packages' checkpoints, resume inside the port, and cli.train, on the CPU.

The JAX side runs with x64 off (float32 throughout, its production
precision); the conftest turns x64 on for everything else. Protocol, for
fno_w at constant lr and at cosine + warm-up + clip, for basis_ode, and
for an fno ensemble of two members:
  1. the JAX trainer saves its initial state (iteration 0);
  2. the port resumes it and trains 2 iterations (checkpoint A), then
     resumes A and trains to 4 (checkpoint B); the JAX trainer resumes
     iteration 0 and trains to 4 (ckpt_every 2);
  3. the reverse: the JAX trainer resumes A and trains to 4.
Bounds, float32: every loss within 1e-5 relative (the same sums in
another order: measured <= 1.3e-6); params within 1e-5 absolute outside
the first spectral layer (measured <= 3e-6), and a root-mean-square
difference over all parameter elements of at most lr / 10 (measured <=
2e-5 at lr 1e-3). The first spectral layer has no elementwise bound:
Adam moves a coordinate whose exact gradient is zero to rounding (its
weights on modes the data does not hold) by that rounding noise
normalised to up to a full step, so the packages part there by up to lr
a step (measured 2.9e-4).
`extrapolate` of the same parameters against the JAX trainer's within
the JAX serve tests' bound, rtol 2e-4 and atol 2e-4 (fno_w's recovery
runs in float64 in the port, in float32 in the JAX package). Resume inside
the port is bitwise: 2 + 2 iterations equal 4, with input noise and
minibatch sampling on.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ns_tpu.cli import train as jax_cli
from ns_tpu.train import ensemble as jens
from ns_tpu.train import trainer as jtr
from ns_tpu_torch.cli import train as port_cli
from ns_tpu_torch.train import ensemble as tens
from ns_tpu_torch.train import trainer as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NT, ITERS, LR = 16, 8, 4, 1e-3


def smooth_data(path, nt=NT, n=N):
    """(u, v, p) rollouts of a few travelling low-wavenumber modes."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    amp = rng.normal(size=(2, 3, 3))

    def field(c, t):
        return sum(amp[c, i, j] * np.cos((i + 1) * X + j * Y
                                         + 0.3 * t * (i + j + 1))
                   for i in range(3) for j in range(3))

    u = np.stack([field(0, t) for t in range(nt)])
    v = np.stack([field(1, t) for t in range(nt)])
    np.savez(path, u=u, v=v, p=0.1 * u * v)
    return str(path)


def ckpt(folder):
    return os.path.join(folder, "checkpoint.npz")


def params_of(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files if k.startswith("params/")}


def assert_params_close(a, b):
    a, b = params_of(a), params_of(b)
    assert sorted(a) == sorted(b)
    diffs = {k: np.abs(a[k] - b[k]) for k in a}
    assert max(d.max() for k, d in diffs.items()
               if not k.startswith("params/spectral/0/")) <= 1e-5
    flat = np.concatenate([d.ravel() for d in diffs.values()])
    assert np.sqrt(np.mean(flat ** 2)) <= LR / 10


def assert_losses_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def run_both_ways(tmp, jax_cls, port_cls, extra=(), **kw):
    """Steps 1-3 of the module docstring. Returns the port's final trainer
    and the losses of the JAX run, the port's and the reverse run."""
    base = dict(npz_path=smooth_data(os.path.join(tmp, "data.npz")),
                n_iters=ITERS, ckpt_every=2, n_coeffs=2, hidden_dim=16,
                fno_width=8, fno_modes=5, n_frames=NT, lr=LR, **kw)
    d = lambda name: os.path.join(tmp, name)  # noqa: E731
    with jax.enable_x64(False):
        jt = jax_cls(jtr.TrainConfig(out_dir=d("j0"), **base), *extra)
        jt.save(0)
        jl = jax_cls(jtr.TrainConfig(out_dir=d("j4"), resume=ckpt(d("j0")),
                                     **base), *extra).train(progress=False)
    cfg = ttr.TrainConfig(out_dir=d("t2"), resume=ckpt(d("j0")),
                          **{**base, "n_iters": 2})
    port_cls(cfg, *extra, device="cpu").train(progress=False)
    shutil.copytree(d("t2"), d("a"))
    tt = port_cls(ttr.TrainConfig(out_dir=d("t4"), resume=ckpt(d("a")),
                                  **base), *extra, device="cpu")
    tl = tt.train(progress=False)
    with jax.enable_x64(False):
        rl = jax_cls(jtr.TrainConfig(out_dir=d("r4"), resume=ckpt(d("a")),
                                     **base), *extra).train(progress=False)
    assert_params_close(ckpt(d("t4")), ckpt(d("j4")))
    assert_params_close(ckpt(d("r4")), ckpt(d("t4")))
    return tt, jl, tl, rl


@pytest.mark.parametrize("model,kw", [
    ("fno_w", {}),
    ("fno_w", dict(lr_schedule="cosine", warmup_iters=2, grad_clip=1.0)),
    ("basis_ode", {})])
def test_trainer_resumes_across_packages(tmp_path, model, kw):
    tt, jl, tl, rl = run_both_ways(str(tmp_path), jtr.Trainer, ttr.Trainer,
                                   model=model, **kw)
    assert_losses_close(tl, jl)
    assert_losses_close(rl, tl)
    if model == "basis_ode":
        with open(ckpt(str(tmp_path / "t4")) + ".meta.json") as f:
            assert len(json.load(f)["penalties"]) == ITERS
    # extrapolate from the same (the port's final) parameters
    with jax.enable_x64(False):
        jt = jtr.Trainer(dataclasses.replace(
            jtr.TrainConfig(**dataclasses.asdict(tt.cfg)),
            resume=ckpt(str(tmp_path / "t4"))))
        want = np.asarray(jt.extrapolate())
    got = tt.extrapolate()
    assert got.shape == want.shape == (NT, 3, N, N)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_ensemble_resumes_across_packages(tmp_path):
    tt, jl, tl, rl = run_both_ways(str(tmp_path), jens.EnsembleTrainer,
                                   tens.EnsembleTrainer, extra=(2,),
                                   model="fno")
    assert np.asarray(tl).shape == (ITERS, 2)
    assert_losses_close(tl, jl)
    assert_losses_close(rl, tl)
    with np.load(ckpt(str(tmp_path / "t4"))) as d:
        assert d["opt_state/0/.count"].tolist() == [ITERS, ITERS]
    with jax.enable_x64(False):
        cfg = jtr.TrainConfig(**dataclasses.asdict(tt.cfg))
        jt = jens.EnsembleTrainer(dataclasses.replace(
            cfg, resume=ckpt(str(tmp_path / "t4"))), 2)
        want = np.asarray(jt.extrapolate())
    got = tt.extrapolate()
    assert got.shape == want.shape == (2, NT, 3, N, N)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kw,n", [(dict(model="rnn"), 2),
                                  (dict(batch_size=2), 2),
                                  (dict(input_noise=0.1), 2), ({}, 1)])
def test_ensemble_checks_raise_where_jax_raises(tmp_path, kw, n):
    cfg = {"model": "fno", "npz_path": smooth_data(tmp_path / "d.npz"),
           "fno_width": 4, "fno_modes": 3, "n_frames": NT, **kw}
    with pytest.raises(ValueError):
        jens.EnsembleTrainer(jtr.TrainConfig(**cfg), n)
    with pytest.raises(ValueError):
        tens.EnsembleTrainer(ttr.TrainConfig(**cfg), n, device="cpu")


def test_resume_is_bitwise_with_noise_and_minibatch(tmp_path):
    base = dict(model="fno", npz_path=smooth_data(tmp_path / "d.npz"),
                fno_width=8, fno_modes=5, n_frames=NT, ckpt_every=2,
                input_noise=0.1, batch_size=3, fno_rollout_steps=2,
                lr_schedule="cosine", warmup_iters=1, grad_clip=1.0)
    whole = ttr.Trainer(ttr.TrainConfig(out_dir=str(tmp_path / "w"),
                                        n_iters=4, **base), device="cpu")
    lw = whole.train(progress=False)
    ttr.Trainer(ttr.TrainConfig(out_dir=str(tmp_path / "h"), n_iters=2,
                                **base), device="cpu").train(progress=False)
    half = ttr.Trainer(ttr.TrainConfig(
        out_dir=str(tmp_path / "h"), n_iters=4,
        resume=ckpt(str(tmp_path / "h")), **base), device="cpu")
    assert half.losses == lw[:2]
    assert half.train(progress=False) == lw
    a, b = params_of(ckpt(str(tmp_path / "w"))), params_of(
        ckpt(str(tmp_path / "h")))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_jax_noise_key_seeds_the_port_generator(tmp_path):
    """A JAX checkpoint's noise_key (two uint32 words) seeds the port's
    generator; the port writes noise_key null and its own state."""
    npz = smooth_data(tmp_path / "d.npz")
    kw = dict(model="fno", npz_path=npz, fno_width=4, fno_modes=3,
              n_frames=NT, input_noise=0.1)
    with jax.enable_x64(False):
        jtr.Trainer(jtr.TrainConfig(out_dir=str(tmp_path / "j"), **kw)
                    ).save(0)
    with open(ckpt(str(tmp_path / "j")) + ".meta.json") as f:
        hi, lo = json.load(f)["noise_key"]
    tr = ttr.Trainer(ttr.TrainConfig(out_dir=str(tmp_path / "t"),
                                     resume=ckpt(str(tmp_path / "j")), **kw),
                     device="cpu")
    want = torch.Generator().manual_seed((hi << 32) | lo).get_state()
    assert torch.equal(tr.gen.get_state(), want)
    tr.save(0)
    with open(ckpt(str(tmp_path / "t")) + ".meta.json") as f:
        meta = json.load(f)
    assert meta["noise_key"] is None and meta["torch_generator"]


# --- cli.train --------------------------------------------------------------


def test_cli_writes_the_jax_cli_files(tmp_path):
    npz = smooth_data(tmp_path / "d.npz")
    argv = ["--model", "fno_w", "--npz-path", npz, "--n-iters", "3",
            "--ckpt-every", "2", "--n-frames", "6", "--fno-width", "4",
            "--fno-modes", "3", "--n-coeffs", "4"]
    with jax.enable_x64(False):
        jax_cli.main(argv + ["--out-dir", str(tmp_path / "j")])
    port_cli.main(argv + ["--out-dir", str(tmp_path / "t"),
                          "--device", "cpu"])
    j, t = tmp_path / "j_4", tmp_path / "t_4"
    assert sorted(os.listdir(j)) == sorted(os.listdir(t))
    for name in ("checkpoint.npz", "extrapolation.npy"):
        a, b = np.load(j / name), np.load(t / name)
        if name.endswith(".npy"):
            assert a.shape == b.shape == (NT, 3, N, N)
            continue
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    metas = [json.load(open(d / "checkpoint.npz.meta.json")) for d in (j, t)]
    assert set(metas[0]) <= set(metas[1])
    assert metas[0]["config"] == metas[1]["config"] | {
        "out_dir": metas[0]["config"]["out_dir"]}
    lines = [open(d / "metrics.jsonl").read().splitlines() for d in (j, t)]
    assert [sorted(json.loads(x)) for x in lines[0]] == [
        sorted(json.loads(x)) for x in lines[1]]


@pytest.mark.parametrize("extra,needle", [
    (["--dist"], "--dist needs a process group"),
    (["--dp", "2", "--n-models", "2"], "--dp shards single-model training"),
    (["--model", "fno3d_a", "--dp", "2", "--dist"],
     "python -m ns_tpu_torch.launch")])
def test_cli_names_what_is_not_ported(tmp_path, capsys, extra, needle,
                                      monkeypatch):
    """--dp and --dist are ported (these cases once checked their "not
    yet ported" exits): the CLI's refusals of --dist without a launcher
    and of --dp with an ensemble, as the JAX CLI's."""
    for var in ("NS_TPU_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit):
        port_cli.main(["--npz-path", "unused.npz", "--device", "cpu"]
                      + extra)
    assert needle in capsys.readouterr().err


def test_cli_needs_a_card_unless_told_cpu(monkeypatch, capsys):
    from ns_tpu_torch.core.device import NO_CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        port_cli.main(["--npz-path", "unused.npz"])
    assert NO_CUDA in capsys.readouterr().err


_NO_JAX = """
import json, sys
import numpy as np
x = np.linspace(0, 2 * np.pi, 8, endpoint=False)
u = np.stack([np.cos(x[:, None] + 0.1 * t + 0 * x) for t in range(5)])
np.savez("d.npz", u=u, v=u.transpose(0, 2, 1), p=u * 0)
from ns_tpu_torch.cli import train
for model in ("fno_w", "basis_gru"):
    train.main(["--model", model, "--npz-path", "d.npz", "--n-iters", "2",
                "--n-frames", "4", "--fno-width", "4", "--fno-modes", "3",
                "--n-coeffs", "2", "--device", "cpu", "--out-dir", model])
train.main(["--model", "fno", "--npz-path", "d.npz", "--n-iters", "1",
            "--n-frames", "4", "--fno-width", "4", "--fno-modes", "3",
            "--n-models", "2", "--device", "cpu", "--out-dir", "ens"])
print(json.dumps({"jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "ns_tpu"))}))
"""


def test_training_path_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _NO_JAX],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"jax": []}
