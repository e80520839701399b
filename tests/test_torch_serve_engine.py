"""The port's serving path (ns_tpu_torch.train.checkpoint, serve.engine,
cli.evaluate) against ns_tpu's, on the CPU: checkpoints written by the JAX
package load unchanged and serve what the JAX engine serves.

Tolerances: float32 `predict`, port against JAX, at the JAX serve tests'
bounds (tests/test_serve.py): rtol 2e-4 and atol 2e-4 for fno_w, whose
w -> (u, v, p) recovery differentiates the prediction; rtol 2e-5 and atol
1e-5 for the other families. Batched against single requests rtol 1e-5,
atol 1e-6, as there. Chunk sizes give equal bits. Evaluation reports,
port against JAX, 1e-4 relative on every number (float32 rollouts and
sums in another order), the divergence maxima, which are rounding noise,
1e-5 of max|u| absolute.
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

from ns_tpu.cli import evaluate as jeval
from ns_tpu.serve.engine import InferenceEngine as JaxEngine
from ns_tpu.serve.engine import _build_model as jax_build
from ns_tpu.train import checkpoint as jck
from ns_tpu.train.trainer import TrainConfig as JaxConfig
from ns_tpu_torch.cli import evaluate as teval
from ns_tpu_torch.serve import InferenceEngine
from ns_tpu_torch.serve.engine import _build_model, load_checkpoint_params
from ns_tpu_torch.train import checkpoint as tck
from ns_tpu_torch.train.trainer import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX = NY = 8
FAMILIES = ["basis_ode", "basis_ode2", "basis_gru", "basis_ode_conv", "rnn",
            "fno", "fno_w", "fno_psi"]
CASES = [(m, t) for m in FAMILIES
         for t in (("fft", "matmul") if m.startswith("fno") else ("auto",))]


def bounds(model):
    return (2e-4, 2e-4) if model == "fno_w" else (2e-5, 1e-5)


def jax_checkpoint(folder, model, transform="auto", n_models=1, seed=0,
                   nx=NX, ny=NY, **kw):
    """A checkpoint as the JAX Trainer writes it ({"params", "opt_state"}
    with meta config and grid) from JAX-initialised float32 params."""
    kw = {"npz_path": "unused.npz", **kw}
    cfg = JaxConfig(model=model, out_dir=str(folder), n_coeffs=2,
                    hidden_dim=16, fno_modes=3, fno_width=6,
                    fno_transform=transform, seed=seed, **kw)
    m = jax_build(cfg, nx, ny)
    if n_models > 1:
        from ns_tpu.train.ensemble import init_ensemble
        params = init_ensemble(m, n_models, seed=seed)
    else:
        params = m.init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    meta = {"config": dataclasses.asdict(cfg), "grid": [nx, ny]}
    if n_models > 1:
        meta["n_models"] = n_models
    return jck.save_checkpoint({"params": params, "opt_state": {}},
                               str(folder), meta=meta)


def frames(n=1, seed=0, nx=NX, ny=NY):
    f = np.random.default_rng(seed).normal(size=(n, 3, nx, ny))
    return f.astype(np.float32)


@pytest.mark.parametrize("model,transform", CASES)
def test_predict_matches_jax(tmp_path, model, transform):
    ckpt = jax_checkpoint(tmp_path, model, transform)
    frame0 = frames()[0]
    want = JaxEngine.from_checkpoint(ckpt, chunk=8).predict(frame0, 5)
    eng = InferenceEngine.from_checkpoint(str(tmp_path), chunk=3,
                                          device="cpu")
    got = eng.predict(frame0, 5)
    assert got.shape == want.shape == (6, 3, NX, NY)
    assert got.dtype == np.float32
    rtol, atol = bounds(model)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("model", ["fno_w", "basis_gru", "rnn"])
def test_batched_matches_single_and_chunks_agree(tmp_path, model):
    ckpt = jax_checkpoint(tmp_path, model)
    x = frames(3, seed=1)
    eng = InferenceEngine.from_checkpoint(ckpt, chunk=2, device="cpu")
    batch = eng.predict(x, 7)
    assert batch.shape == (3, 8, 3, NX, NY)
    for i in range(3):
        np.testing.assert_allclose(batch[i], eng.predict(x[i], 7),
                                   rtol=1e-5, atol=1e-6)
    long = InferenceEngine.from_checkpoint(ckpt, chunk=64, device="cpu")
    np.testing.assert_array_equal(long.predict(x, 7), batch)
    assert eng.predict(x[0], 0).shape == (1, 3, NX, NY)


def test_ensemble_checkpoint(tmp_path):
    """An EnsembleTrainer-style checkpoint (a leading member axis on every
    leaf): members start from the same state, the reply gains the member
    axis, and each member is JAX's."""
    ckpt = jax_checkpoint(tmp_path, "fno", "matmul", n_models=2)
    x = frames(2, seed=2)
    want = JaxEngine.from_checkpoint(ckpt, chunk=4).predict(x, 4)
    eng = InferenceEngine.from_checkpoint(ckpt, chunk=3, device="cpu")
    assert eng.n_models == 2
    got = eng.predict(x, 4)
    assert got.shape == want.shape == (2, 2, 5, 3, NX, NY)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0, :, 0], got[1, :, 0])
    assert not np.allclose(got[0, :, 1:], got[1, :, 1:])
    single = eng.predict(x[0], 4)
    assert single.shape == (2, 5, 3, NX, NY)


def test_jax_trainer_checkpoint_serves(tmp_path):
    """A real JAX Trainer checkpoint (fno_w, 8^2, 2 iterations), with its
    opt_state leaves, loads unchanged; predict matches JAX's engine."""
    from ns_tpu.train.trainer import Trainer

    rng = np.random.default_rng(3)
    npz = str(tmp_path / "data.npz")
    np.savez(npz, **{k: rng.normal(size=(6, NX, NY)) for k in "uvp"})
    cfg = JaxConfig(model="fno_w", npz_path=npz, out_dir=str(tmp_path / "c"),
                    n_iters=2, n_frames=6, ckpt_every=2, fno_modes=3,
                    fno_width=6)
    Trainer(cfg).train(progress=False)
    ckpt = str(tmp_path / "c")
    with np.load(os.path.join(ckpt, "checkpoint.npz")) as d:
        assert any(k.startswith("opt_state/") for k in d.files)
    frame0 = frames(seed=4)[0]
    want = JaxEngine.from_checkpoint(ckpt).predict(frame0, 6)
    eng = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    np.testing.assert_allclose(eng.predict(frame0, 6), want, rtol=2e-4,
                               atol=2e-4)
    s = eng.stats()
    assert set(s) == set(JaxEngine.from_checkpoint(ckpt).stats())
    assert (s["requests"], s["steps_served"], s["grid"]) == (1, 6, [NX, NY])
    eng.warmup(2, batch=2)
    assert eng.stats()["steps_served"] == 10


def test_checkpoint_without_grid_reads_it_from_its_data(tmp_path):
    """A checkpoint from before meta["grid"] existed: the grid comes from
    the data file it was trained on, as in the JAX engine."""
    npz = str(tmp_path / "data.npz")
    np.savez(npz, **{k: np.zeros((4, 10, 6)) for k in "uvp"})
    ckpt = jax_checkpoint(tmp_path / "c", "fno", "matmul", nx=10, ny=6,
                          npz_path=npz)
    meta = tck.load_meta(ckpt)
    del meta["grid"]
    with open(ckpt + ".meta.json", "w") as f:
        json.dump(meta, f)
    eng = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    assert (eng.nx, eng.ny) == (10, 6)
    x = frames(nx=10, ny=6)[0]
    np.testing.assert_allclose(eng.predict(x, 3),
                               JaxEngine.from_checkpoint(ckpt).predict(x, 3),
                               rtol=2e-5, atol=1e-5)


def test_params_to_jax_round_trip(tmp_path):
    """params_to_jax + the port's save_checkpoint write the file the JAX
    Trainer writes: JAX's load_checkpoint restores it into its template
    and JAX's engine serves it."""
    cfg = TrainConfig(model="fno_psi", fno_modes=3, fno_width=6)
    torch.manual_seed(5)
    flat = tck.params_to_jax(_build_model(cfg, NX, NY))
    path = tck.save_checkpoint(
        {"params": flat, "opt_state": {}}, str(tmp_path),
        meta={"config": dataclasses.asdict(cfg), "grid": [NX, NY]})
    jcfg = JaxConfig(model="fno_psi", fno_modes=3, fno_width=6)
    template = {"params": jax_build(jcfg, NX, NY).init(
        jax.random.PRNGKey(0)), "opt_state": {}}
    template = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      template)
    restored = jck.load_checkpoint(path, template)
    for k, v in jck._flatten_with_paths(restored["params"]).items():
        np.testing.assert_array_equal(v, flat[k])
    x = frames(seed=6)[0]
    np.testing.assert_allclose(
        InferenceEngine.from_checkpoint(path, device="cpu").predict(x, 3),
        JaxEngine.from_checkpoint(path).predict(x, 3), rtol=2e-5, atol=1e-5)
    # and the port's own load_checkpoint reads the JAX-format file back
    back = tck.load_checkpoint(path, {"params": flat, "opt_state": {}})
    for k, v in back["params"].items():
        np.testing.assert_array_equal(v, flat[k])


def test_manifest_errors(tmp_path):
    """Leaf-by-leaf errors naming what is missing, unexpected, reshaped or
    recast; a format version mismatch; format 1 (`__treedef__`) files."""
    flat = {"a/w": np.zeros((2, 3), np.float32), "a/b": np.ones(3, np.float32)}
    path = tck.save_checkpoint({"params": flat}, str(tmp_path))
    like = {"params": {"a/w": np.zeros((2, 3), np.float32),
                       "c": np.zeros(1, np.float32)}}
    with pytest.raises(ValueError) as e:
        tck.load_checkpoint(path, like)
    msg = str(e.value)
    assert "['params/c']" in msg and "['params/a/b']" in msg
    like = {"params": {"a/w": np.zeros((3, 2), np.float32),
                       "a/b": np.ones(3, np.float64)}}
    with pytest.raises(ValueError) as e:
        tck.load_checkpoint(path, like)
    assert "shape mismatch at 'params/a/w'" in str(e.value)
    assert "dtype mismatch at 'params/a/b'" in str(e.value)
    like["params"]["a/w"] = np.zeros((2, 3), np.float32)
    out = tck.load_checkpoint(path, like, allow_cast=True)
    assert out["params"]["a/b"].dtype == np.float64
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files if k != "__manifest__"}
    manifest = json.dumps({"format_version": 3, "leaves": {}}).encode()
    np.savez(tmp_path / "v3.npz", __manifest__=np.frombuffer(manifest,
                                                             np.uint8),
             **arrays)
    with pytest.raises(ValueError, match="format_version 3"):
        tck.load_checkpoint(str(tmp_path / "v3.npz"), like)
    np.savez(tmp_path / "v1.npz", __treedef__=np.zeros(1), **arrays)
    out = tck.load_checkpoint(str(tmp_path / "v1.npz"), like,
                              allow_cast=True)
    np.testing.assert_array_equal(out["params"]["a/b"], flat["a/b"])


def test_wrong_config_names_the_leaves(tmp_path):
    ckpt = jax_checkpoint(tmp_path / "c", "fno")
    meta = tck.load_meta(ckpt)
    meta["config"]["fno_width"] = 12
    alt = tmp_path / "wrong"
    os.makedirs(alt)
    shutil.copyfile(ckpt, alt / "checkpoint.npz")
    with open(alt / "checkpoint.npz.meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="shape"):
        InferenceEngine.from_checkpoint(str(alt), device="cpu")
    meta["config"].update(fno_width=6, fno_transform="fft")
    with open(alt / "checkpoint.npz.meta.json", "w") as f:
        json.dump(meta, f)
    InferenceEngine.from_checkpoint(str(alt), device="cpu")  # same leaves
    cfg = TrainConfig(model="rnn", hidden_dim=16)
    with pytest.raises(ValueError, match=r"missing params leaves \['gru/"):
        load_checkpoint_params(ckpt, _build_model(cfg, NX, NY))
    eng = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    with pytest.raises(ValueError, match="frame0"):
        eng.predict(np.zeros((3, NX + 1, NY), np.float32), 1)
    with pytest.raises(ValueError, match="n_steps"):
        eng.predict(np.zeros((3, NX, NY), np.float32), -1)
    with pytest.raises(ValueError, match="chunk"):
        InferenceEngine(eng.cfg, eng.models, NX, NY, chunk=0, device="cpu")
    for model in ("fno3d", "fno3d_a"):  # the 3D families' leaves are JAX's
        kw3 = dict(model=model, fno_modes=3, fno_width=6)
        m3 = _build_model(TrainConfig(**kw3), NX, NY, NX)
        want = jck._flatten_with_paths(jax_build(
            JaxConfig(**kw3), NX, NY, NX).init(jax.random.PRNGKey(0)))
        assert {k: tuple(v.shape) for k, v in want.items()} == {
            k: tuple(v.shape) for k, v in tck.params_to_jax(m3).items()}


def test_train_config_is_the_jax_config():
    """Every TrainConfig field, default and check of the JAX package's:
    from_checkpoint rebuilds it by field name, so a missing field would
    silently take its default."""
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs
    for bad in (dict(model="mlp"), dict(fno_transform="dft"),
                dict(fno_precision="sloppy"), dict(n_iters=-1),
                dict(ckpt_every=0), dict(dp=0), dict(lr_schedule="step"),
                dict(warmup_iters=-1), dict(schedule_horizon=0),
                dict(grad_clip=-1.0), dict(batch_size=-1),
                dict(model="rnn", batch_size=4)):
        with pytest.raises(ValueError) as e:
            TrainConfig(**bad)
        with pytest.raises(ValueError) as f:
            JaxConfig(**bad)
        assert str(e.value) == str(f.value)


def _obs_npz(tmp_path, nt=7):
    """A periodic (u, v, p) rollout: decaying turbulence on 8^2."""
    from ns_tpu_torch.solvers import spectral_periodic as sp

    cfg = sp.SpectralPeriodicConfig(nx=NX, ny=NY, dt=0.01, nu=0.05)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=0, k_peak=2.0)
    u, v, p = sp.simulate_strided(cfg, w0, nt, device="cpu")
    path = str(tmp_path / "obs.npz")
    np.savez(path, u=u.numpy(), v=v.numpy(), p=p.numpy())
    return path


def _reports_close(got, want, umax):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            if k.startswith("divergence_max"):
                assert abs(got[k] - want[k]) <= 1e-5 * umax
            elif k not in ("source", "npz_path"):
                _reports_close(got[k], want[k], umax)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _reports_close(a, b, umax)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-4 * abs(want) + 1e-12
    else:
        assert got == want


def test_evaluate_reports_match_jax(tmp_path, capsys):
    """cli.evaluate --ckpt --physics --json and --extrapolation --offset:
    the port's JSON report against JAX's."""
    npz = _obs_npz(tmp_path)
    with np.load(npz) as d:
        umax = float(np.abs(d["u"]).max())
    ckpt = jax_checkpoint(tmp_path / "c", "fno_w", "matmul", n_frames=4)
    reports = {}
    for name, mod, extra in (("jax", jeval, []),
                             ("port", teval, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.json")
        mod.main(["--ckpt", ckpt, "--npz-path", npz, "--physics", "--json",
                  out] + extra)
        with open(out) as f:
            reports[name] = json.load(f)
    _reports_close(reports["port"], reports["jax"], umax)
    assert "physics" in reports["port"]
    ens = jax_checkpoint(tmp_path / "e", "fno", "fft", n_models=2,
                         n_frames=4)
    a = teval.main(["--ckpt", ens, "--npz-path", npz, "--device", "cpu"])
    jeval.main(["--ckpt", ens, "--npz-path", npz, "--json",
                str(tmp_path / "e.json")])
    with open(tmp_path / "e.json") as f:
        _reports_close(json.loads(json.dumps(a)), json.load(f), umax)
    extrap = str(tmp_path / "extrap.npy")
    with np.load(npz) as d:
        obs = np.stack([d[k] for k in "uvp"], axis=1)
    np.save(extrap, obs[:-1] + 0.01)
    argv = ["--extrapolation", extrap, "--npz-path", npz, "--offset", "1",
            "--n-frames", "4"]
    a = teval.main(argv)
    jeval.main(argv + ["--json", str(tmp_path / "x.json")])
    with open(tmp_path / "x.json") as f:
        _reports_close(json.loads(json.dumps(a)), json.load(f), umax)


def test_no_card_needs_device_cpu(tmp_path, monkeypatch):
    """Without a card the engine raises unless given device="cpu", and
    cli.evaluate --ckpt / --physics exit with an error unless given
    --device cpu; --extrapolation without --physics stays numpy only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = jax_checkpoint(tmp_path / "c", "fno", "matmul")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        InferenceEngine.from_checkpoint(ckpt)
    eng = InferenceEngine.from_checkpoint(ckpt, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(eng.cfg, eng.models, NX, NY)
    npz = _obs_npz(tmp_path)
    for extra in (["--ckpt", ckpt], ["--ckpt", ckpt, "--physics"]):
        with pytest.raises(SystemExit) as e:
            teval.main(extra + ["--npz-path", npz])
        assert e.value.code != 0
    extrap = str(tmp_path / "extrap.npy")
    with np.load(npz) as d:
        np.save(extrap, np.stack([d[k] for k in "uvp"], axis=1))
    with pytest.raises(SystemExit):
        teval.main(["--extrapolation", extrap, "--npz-path", npz,
                    "--physics"])
    report = teval.main(["--extrapolation", extrap, "--npz-path", npz])
    assert report["windows"]["full"]["rel_l2"] == 0.0


_NO_JAX = """
import dataclasses, json, sys, tempfile
import numpy as np
from ns_tpu_torch import models
from ns_tpu_torch.cli import evaluate
from ns_tpu_torch.models import (basis, fno, gru, layers, node, projection,
                                 streamfunction, vorticity)
from ns_tpu_torch.serve import InferenceEngine
from ns_tpu_torch.serve.engine import _build_model
from ns_tpu_torch.train import checkpoint, metrics, trainer
cfg = trainer.TrainConfig(model="fno_w", fno_modes=3, fno_width=4)
d = tempfile.mkdtemp()
checkpoint.save_checkpoint(
    {"params": checkpoint.params_to_jax(_build_model(cfg, 8, 8)),
     "opt_state": {}}, d,
    meta={"config": dataclasses.asdict(cfg), "grid": [8, 8]})
out = InferenceEngine.from_checkpoint(d, device="cpu").predict(
    np.zeros((3, 8, 8), np.float32), 3)
print(json.dumps({"jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "ns_tpu")),
                  "shape": list(out.shape)}))
"""


def test_serving_path_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _NO_JAX],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"jax": [], "shape": [4, 3, 8, 8]}
