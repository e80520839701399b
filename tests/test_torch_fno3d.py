"""The port's 3D surrogates (ns_tpu_torch.models.fno3d and the 3D branches
of train.trainer, train.ensemble, serve.engine, cli.train and
cli.evaluate) against ns_tpu's, on the CPU.

Tolerances:
  - float64, the same parameters carried by key path and the same numpy
    inputs: the forward and the training objective and every gradient
    <= 1e-10 of their scale (the same sums in another order differ at
    ~1e-15). The spectral weights are drawn at scale 1, so the spectral
    path carries the output; their mixed spectra are not Hermitian on the
    kz = 0 plane, the case that `spectral3d.irfft3` inverts.
  - the 'default' mixing in float32 against float64 <= 2e-5 of max|out|
    (fp32 rounding, ~1e-6); a control that rounds the mixing's operands
    to bf16 (~1e-3) must fail that bound.
  - JAX checkpoints served by the port: the JAX serve tests' bounds, rtol
    1e-5 and atol 1e-6 for fno3d (tests/test_fno3d.py), rtol 1e-4 and
    atol 1e-5 for fno3d_w and fno3d_a, whose (u, v, w, p) recovery
    differentiates the prediction (tests/test_vorticity3d.py); the port
    recovers in float64, the JAX package in float32.
  - training across the packages (float32, the JAX side at x64 off):
    losses within 1e-5 relative, parameters as in
    tests/test_torch_train_resume.py; resume inside the port bitwise.
  - cli.evaluate reports 1e-4 relative (float32 rollouts and sums in
    another order), the divergence maxima 1e-5 of max|u|.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.cli import evaluate as jeval
from ns_tpu.cli import train as jcli
from ns_tpu.models import fno3d as jf3
from ns_tpu.models import vorticity3d as jv3
from ns_tpu.serve.engine import InferenceEngine as JaxEngine
from ns_tpu.serve.engine import _build_model as jax_build
from ns_tpu.train import ensemble as jens
from ns_tpu.train import trainer as jtr
from ns_tpu.train.checkpoint import _flatten_with_paths
from ns_tpu.train.metrics import l2_loss as jax_l2
from ns_tpu_torch.cli import evaluate as teval
from ns_tpu_torch.cli import train as tcli
from ns_tpu_torch.models import fno as tf
from ns_tpu_torch.models import fno3d as tf3
from ns_tpu_torch.serve import InferenceEngine
from ns_tpu_torch.train import ensemble as tens
from ns_tpu_torch.train import trainer as ttr
from ns_tpu_torch.train.checkpoint import jax_key, params_from_jax
from ns_tpu_torch.train.metrics import l2_loss
from test_torch_serve_engine import _reports_close
from test_torch_train_resume import assert_params_close, ckpt, params_of

# even, odd and mixed grids: mz = nz//2 + 1 keeps the Nyquist plane at 8
SHAPES = [(10, 10, 10), (9, 8, 7), (8, 10, 4)]


def rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def close(got, want, rel=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def models(shape, scale1=True, seed=0, dtype=torch.float64, **kw):
    """A JAX FNO3D's float64 params (spectral weights at scale 1) and the
    port's FNO3D carrying them."""
    kw = dict(width=6, modes=3, depth=2, **kw)
    jm = jf3.FNO3D(*shape, **kw)
    p = jm.init(jax.random.PRNGKey(seed))
    if scale1:
        p["spectral"] = [{k: v * kw["width"] ** 2 for k, v in s.items()}
                         for s in p["spectral"]]
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), p)
    tm = tf3.FNO3D(*shape, dtype=dtype, **kw)
    return jm, p, params_from_jax(tm, _flatten_with_paths(p))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("precision", [None, "default"])
@pytest.mark.parametrize("transform", ["fft", "matmul"])
def test_forward_matches_jax(transform, precision, shape):
    channels = 3 if shape == SHAPES[1] else 4
    jm, p, tm = models(shape, transform=transform, precision=precision,
                       channels=channels)
    assert tm.transform == jm.transform and (tm.mx, tm.my, tm.mz) == (
        jm.mx, jm.my, jm.mz)
    x = rand(2, channels, *shape)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    close(got.numpy(), jax.jit(jm.apply)(p, jnp.asarray(x)))


def test_rollout_with_filter_matches_jax():
    from ns_tpu.models.projection import rollout_filter3d as jfilt
    from ns_tpu_torch.models.projection import rollout_filter3d as tfilt
    jm, p, tm = models((8, 8, 8), transform="matmul")
    x = rand(4, 8, 8, 8, seed=1)
    with torch.no_grad():
        got = tm.rollout(torch.tensor(x), 3, post=tfilt)
    want = jax.jit(lambda q, y: jm.rollout(q, y, 3, post=jfilt))(
        p, jnp.asarray(x))
    close(got.numpy(), want)


def test_mixed_spectrum_is_not_hermitian_and_engines_agree():
    """Random complex weights: the fft engine's kz = 0 plane is far from
    Hermitian, and it still equals the matmul engine (which takes only
    the real part of its inverse) and JAX."""
    _, _, tm = models((8, 8, 8))
    W = tm.spectral[0].mixing_table(torch.float64).detach()
    h = torch.tensor(rand(2, 6, 8, 8, 8, seed=2))
    xh = torch.fft.rfftn(h, dim=(-3, -2, -1))
    m = tm.mx
    block = torch.cat([torch.cat([q[..., :m, :], q[..., 8 - m:, :]], dim=-2)
                       for q in (xh[..., :m, :, :tm.mz],
                                 xh[..., 8 - m:, :, :tm.mz])], dim=-3)
    z0 = tf3._mix3d(block, W)[..., 0]            # kz = 0, (2mx, 2my) rows
    rows = np.concatenate([np.arange(m), np.arange(8 - m, 8)])
    neg = [int(np.nonzero(rows == (-r) % 8)[0][0]) for r in rows[1:m]]
    neg = torch.tensor(neg)
    mirror = z0.index_select(-2, neg).index_select(-1, neg).conj()
    herm = (z0[..., 1:m, 1:m] - mirror).abs()
    assert float(herm.max()) > 0.1 * float(z0.abs().max())
    a = tf3._spectral_conv3d_fft(W, h, m, m, tm.mz)
    b = tf3._spectral_conv3d_matmul(W, h, m, m, tm.mz)
    close(a.numpy(), b.numpy())


def test_a_transposed_mixing_table_fails():
    """Every spectral layer is width x width, so a table built with
    permute(2, 0, 1) passes every shape check: only the values show it."""
    jm, p, tm = models((8, 8, 8), transform="fft")
    x = rand(2, 4, 8, 8, 8, seed=3)
    want = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x)))
    with torch.no_grad():
        close(tm(torch.tensor(x)).numpy(), want)
        right = tf3.SpectralWeights3D.mixing_table
        try:
            tf3.SpectralWeights3D.mixing_table = (
                lambda s, dt: right(s, dt).transpose(1, 2))
            wrong = tm(torch.tensor(x)).numpy()
        finally:
            tf3.SpectralWeights3D.mixing_table = right
    assert np.abs(wrong - want).max() > 1e-3 * np.abs(want).max()


def test_default_mixing_is_fp32():
    """At 'default' the fft engine's only product of the spectral path is
    the mixing, which JAX computes without a precision: float32 stays at
    fp32 rounding from float64; bf16-rounded mixing does not."""
    _, p, t64 = models((10, 10, 10), transform="fft", precision="default")
    t32 = tf3.FNO3D(10, 10, 10, width=6, modes=3, depth=2,
                    transform="fft", precision="default")
    params_from_jax(t32, _flatten_with_paths(p))
    x = rand(2, 4, 10, 10, 10, seed=4)
    with torch.no_grad():
        want = t64(torch.tensor(x)).numpy()
        scale = np.abs(want).max()
        err = np.abs(t32(torch.tensor(x).float()).numpy() - want).max()
        mix = tf3._mix3d
        try:
            tf3._mix3d = lambda block, W: _bf16_mix(block, W)
            control = np.abs(t32(torch.tensor(x).float()).numpy()
                             - want).max()
        finally:
            tf3._mix3d = mix
    assert err <= 2e-5 * scale < control


def _bf16_mix(block, W):
    lead, (C, X, Y, Z) = block.shape[:-4], block.shape[-4:]
    b = block.reshape(-1, C, X * Y * Z).permute(2, 0, 1)
    out = tf._cmm(b, W, "default")
    return out.permute(1, 2, 0).reshape(*lead, W.shape[-1], X, Y, Z)


@pytest.mark.parametrize("kw", [dict(transform="dft"),
                                dict(precision="sloppy")])
def test_validation_errors_equal_jax(kw):
    with pytest.raises(ValueError) as e:
        tf3.FNO3D(8, 8, 8, **kw)
    with pytest.raises(ValueError) as f:
        jf3.FNO3D(8, 8, 8, **kw)
    assert str(e.value) == str(f.value)



@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_weight_gradient_over_a_long_contraction(dtype):
    """ops/gemm.py's weight gradient of w @ h (float32 and complex64, the
    products it runs itself) for a batch under 64 over a long contraction,
    a dense layer on a 3D grid, is cut into pieces of 1024 summed after
    one batched product (4 x 32 pieces here); fno_w's 99 windows over
    128^2 and a batch of 128 are not cut; either way it is the float64 sum
    to fp32 rounding (<= 1e-6; at 'default' the float64 sum of the
    bf16-rounded operands)."""
    from ns_tpu_torch.ops import gemm

    gen = torch.Generator().manual_seed(0)
    wide = torch.float64 if dtype == torch.float32 else torch.complex128
    for b, n, pieces in ((4, 1 << 15, (4, 32, 6, 1024)),
                         (99, 1 << 14, (99, 1, 6, 1 << 14)),
                         (128, 4096, (128, 1, 6, 4096))):
        shapes = []
        gemm._batch_contract(lambda x, y: shapes.append(x.shape) or x @ y,
                             torch.zeros(b, 6, n), torch.zeros(b, n, 5))
        assert shapes == [pieces]
        w = torch.randn(6, 5, generator=gen, dtype=dtype).requires_grad_()
        h = torch.randn(b, 5, n, generator=gen, dtype=dtype)
        for prec in ((None, "default") if dtype == torch.float32
                     else (None,)):
            out = gemm.matmul(w, h, prec)
            g = torch.randn(out.shape, generator=gen, dtype=dtype)
            got, = torch.autograd.grad(out, w, g)
            r = (lambda t: t.to(torch.bfloat16).to(wide)) if prec else (
                lambda t: t.to(wide))
            want = (r(g) @ r(h).mH).sum(0)
            assert float((got - want).abs().max()) <= 1e-6 * float(
                want.abs().max())


# --- the training objective -----------------------------------------------

N, NT = 8, 7
OBJECTIVES = [("fno3d", "fft", dict(fno_project=True)),
              ("fno3d", "matmul", dict(fno_project=True)),
              ("fno3d_w", "matmul", {}), ("fno3d_w", "fft", {}),
              ("fno3d_a", "fft", {}), ("fno3d_a", "matmul", {})]


def configs(model, transform="auto", **kw):
    kw = dict(model=model, fno_width=4, fno_modes=3, fno_transform=transform,
              **kw)
    return jtr.TrainConfig(**kw), ttr.TrainConfig(**kw)


@pytest.mark.parametrize("model,transform,kw", OBJECTIVES)
def test_objective_and_gradient_match_jax(monkeypatch, model, transform, kw):
    """4-step pushforward with remat, the rollout filter (fno3d: dealias
    and Leray projection), input noise and minibatch windows: the port
    draws the windows and the noise from its generator and the JAX
    objective is given the same draws."""
    bs = 3
    jcfg, tcfg = configs(model, transform, fno_rollout_steps=4,
                         fno_remat=True, input_noise=0.1, batch_size=bs,
                         **kw)
    jm = jax_build(jcfg, N, N, N)
    p = jm.init(jax.random.PRNGKey(0))
    p["spectral"] = [{k: v * 4 for k, v in s.items()} for s in p["spectral"]]
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), p)
    obs = rand(NT, 1, 4, N, N, N, seed=5)

    tm = ttr.build_model(tcfg, N, N, N, dtype=torch.float64)
    params_from_jax(tm, _flatten_with_paths(p))
    frames, scale = ttr.training_tensors(tcfg, torch.tensor(obs))
    loss = l2_loss(*ttr.build_forward(tcfg, frames, scale)(
        tm, torch.Generator().manual_seed(7)))
    named = list(tm.named_parameters())
    grads = torch.autograd.grad(loss, [q for _, q in named])
    grads = {jax_key(n): g.numpy() for (n, _), g in zip(named, grads)}

    g = torch.Generator().manual_seed(7)
    idx = torch.randint(0, NT - 4, (bs,), generator=g)
    noise = torch.randn((bs,) + tuple(frames.shape[1:]), generator=g,
                        dtype=torch.float64)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(idx.numpy()))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            noise.numpy()))
    jobs = jnp.asarray(obs)
    wf = None
    if model in ("fno3d_w", "fno3d_a"):
        wf = jv3.repr3d_fns(model)[0](jobs[:, :, :3], dtype="float64")
    fwd = jtr.build_forward(jcfg, jm, jobs, wf, scale)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: jax_l2(*fwd(q, jax.random.PRNGKey(1)))))(p)
    jg = _flatten_with_paths(jg)
    assert sorted(grads) == sorted(jg)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-10 * abs(float(jl))
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    for k, gk in grads.items():
        np.testing.assert_allclose(gk, jg[k], rtol=0, atol=1e-10 * gmax,
                                   err_msg=k)


def test_extrapolation_matches_jax():
    """The closed-loop extrapolation from frame 0 with the recovery, both
    packages in float64 (the JAX recovery given dtype="float64")."""
    import functools
    for model in ("fno3d_a", "fno3d"):
        jcfg, tcfg = configs(model, "matmul", fno_project=True)
        jm = jf3.FNO3D(N, N, N, width=4, modes=3,
                       channels=4 if model == "fno3d" else 3,
                       transform="matmul")
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   jm.init(jax.random.PRNGKey(2)))
        tm = ttr.build_model(tcfg, N, N, N, dtype=torch.float64)
        params_from_jax(tm, _flatten_with_paths(p))
        obs = rand(5, 1, 4, N, N, N, seed=6)
        got = ttr.extrapolate_model(tcfg, tm, torch.tensor(obs)).numpy()
        post = jtr.rollout_post(jcfg)
        x0 = jnp.asarray(obs[0, 0])
        if model == "fno3d":
            want = jnp.concatenate([x0[None], jm.rollout(p, x0, 4,
                                                         post=post)])
        else:
            to_r, to_u = (functools.partial(f, dtype="float64")
                          for f in jv3.repr3d_fns(model))
            r0 = to_r(x0[:3])
            seq = jnp.concatenate([r0[None], jm.rollout(p, r0, 4,
                                                        post=post)])
            want = jax.vmap(to_u)(seq)
        assert got.shape == (5, 4, N, N, N)
        close(got, want)


# --- checkpoints, training, serving and the CLIs across the packages -------


def turbulence3d(path, nt=8, n=N):
    """(u, v, w, p) frames of the port's 3D decaying turbulence (CPU)."""
    from ns_tpu_torch.solvers import spectral3d as s3
    cfg = s3.Spectral3DConfig(nx=n, ny=n, nz=n, dt=0.01, nu=1e-2)
    u0 = s3.random_solenoidal_velocity(cfg, seed=0, k_peak=2.0)
    u, v, w, p = s3.simulate_strided(cfg, u0, nt, stride=2, device="cpu")
    np.savez(path, u=u.numpy(), v=v.numpy(), w=w.numpy(), p=p.numpy())
    return str(path)


def serve_bounds(model):
    return (1e-5, 1e-6) if model == "fno3d" else (1e-4, 1e-5)


BASE = dict(n_iters=4, ckpt_every=2, fno_width=4, fno_modes=3, n_frames=8)


@pytest.mark.parametrize("model,kw", [
    ("fno3d_a", dict(fno_rollout_steps=2, lr_schedule="cosine",
                     warmup_iters=1, grad_clip=1.0)),
    ("fno3d", dict(fno_project=True))])
def test_trainer_resumes_across_packages_and_serves(tmp_path, model, kw):
    """JAX iteration 0 -> the port to 2 (A) -> the port to 4, against JAX 0
    -> 4 and JAX A -> 4; A served by both engines."""
    base = dict(model=model, npz_path=turbulence3d(tmp_path / "d.npz"),
                **BASE, **kw)
    d = lambda name: str(tmp_path / name)  # noqa: E731
    with jax.enable_x64(False):
        jtr.Trainer(jtr.TrainConfig(out_dir=d("j0"), **base)).save(0)
        jl = jtr.Trainer(jtr.TrainConfig(out_dir=d("j4"), resume=ckpt(
            d("j0")), **base)).train(progress=False)
    ttr.Trainer(ttr.TrainConfig(out_dir=d("t2"), resume=ckpt(d("j0")),
                                **{**base, "n_iters": 2}),
                device="cpu").train(progress=False)
    shutil.copytree(d("t2"), d("a"))
    tl = ttr.Trainer(ttr.TrainConfig(out_dir=d("t4"), resume=ckpt(d("a")),
                                     **base), device="cpu").train(
                                         progress=False)
    with jax.enable_x64(False):
        rl = jtr.Trainer(jtr.TrainConfig(out_dir=d("r4"), resume=ckpt(
            d("a")), **base)).train(progress=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    np.testing.assert_allclose(rl, tl, rtol=1e-5, atol=0)
    assert_params_close(ckpt(d("t4")), ckpt(d("j4")))
    assert_params_close(ckpt(d("r4")), ckpt(d("t4")))
    with open(ckpt(d("t4")) + ".meta.json") as f:
        assert json.load(f)["grid"] == [N, N, N]
    # the port's iteration-2 checkpoint served by both engines
    with np.load(base["npz_path"]) as data:
        x = np.stack([data[k][:2] for k in "uvwp"], axis=1)
    with jax.enable_x64(False):
        want = JaxEngine.from_checkpoint(d("a"), chunk=4).predict(x, 5)
    eng = InferenceEngine.from_checkpoint(d("a"), chunk=3, device="cpu")
    got = eng.predict(x, 5)
    assert got.shape == want.shape == (2, 6, 4, N, N, N)
    rtol, atol = serve_bounds(model)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(eng.predict(x[1], 5), got[1], rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="frame0"):
        eng.predict(np.zeros((3, N, N, N), np.float32), 1)


def test_jax_checkpoint_of_each_family_serves(tmp_path):
    """JAX-initialised fno3d_w and fno3d_a checkpoints (float32) served by
    both engines, single and batched."""
    from ns_tpu.train import checkpoint as jck
    x = np.stack([rand(4, N, N, N, seed=s) for s in (8, 9)]).astype(
        np.float32)
    for model in ("fno3d_w", "fno3d_a"):
        cfg = jtr.TrainConfig(model=model, fno_width=6, fno_modes=3,
                              npz_path="unused.npz")
        with jax.enable_x64(False):
            params = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32),
                jax_build(cfg, N, N, N).init(jax.random.PRNGKey(1)))
            path = jck.save_checkpoint(
                {"params": params, "opt_state": {}}, str(tmp_path / model),
                meta={"config": dataclasses.asdict(cfg), "grid": [N, N, N]})
            want = JaxEngine.from_checkpoint(path, chunk=2).predict(x, 3)
        eng = InferenceEngine.from_checkpoint(path, chunk=2, device="cpu")
        assert eng.nz == N
        rtol, atol = serve_bounds(model)
        np.testing.assert_allclose(eng.predict(x, 3), want, rtol=rtol,
                                   atol=atol)


def test_resume_is_bitwise(tmp_path):
    base = dict(model="fno3d_a", npz_path=turbulence3d(tmp_path / "d.npz"),
                **{**BASE, "n_frames": 6}, input_noise=0.1, batch_size=2,
                fno_rollout_steps=2, fno_remat=True)
    whole = ttr.Trainer(ttr.TrainConfig(out_dir=str(tmp_path / "w"),
                                        **base), device="cpu")
    lw = whole.train(progress=False)
    ttr.Trainer(ttr.TrainConfig(out_dir=str(tmp_path / "h"),
                                **{**base, "n_iters": 2}),
                device="cpu").train(progress=False)
    half = ttr.Trainer(ttr.TrainConfig(out_dir=str(tmp_path / "h"),
                                       resume=ckpt(str(tmp_path / "h")),
                                       **base), device="cpu")
    assert half.train(progress=False) == lw
    a, b = params_of(ckpt(str(tmp_path / "w"))), params_of(
        ckpt(str(tmp_path / "h")))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_ensemble_of_two_3d_members_matches_jax(tmp_path):
    base = dict(model="fno3d_w", npz_path=turbulence3d(tmp_path / "d.npz"),
                **{**BASE, "n_frames": 5, "n_iters": 2})
    with jax.enable_x64(False):
        jens.EnsembleTrainer(jtr.TrainConfig(out_dir=str(tmp_path / "j0"),
                                             **base), 2, mesh=None).save(0)
        jt = jens.EnsembleTrainer(jtr.TrainConfig(
            out_dir=str(tmp_path / "j"), resume=ckpt(str(tmp_path / "j0")),
            **base), 2, mesh=None)
        jl = jt.train(progress=False)
        want = np.asarray(jt.extrapolate())
    tt = tens.EnsembleTrainer(ttr.TrainConfig(
        out_dir=str(tmp_path / "t"), resume=ckpt(str(tmp_path / "j0")),
        **base), 2, device="cpu")
    tl = tt.train(progress=False)
    assert np.asarray(tl).shape == (2, 2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert_params_close(ckpt(str(tmp_path / "t")), ckpt(str(tmp_path / "j")))
    got = tt.extrapolate()
    assert got.shape == want.shape == (2, 8, 4, N, N, N)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    with open(ckpt(str(tmp_path / "t")) + ".meta.json") as f:
        meta = json.load(f)
    assert meta["grid"] == [N, N, N] and meta["n_models"] == 2


def test_cli_train_and_evaluate_match_the_jax_clis(tmp_path):
    """cli.train fno3d_a writes the JAX CLI's files; cli.evaluate --ckpt
    --physics --json of the JAX run's checkpoint matches the JAX CLI's
    report; --physics on a saved 3D extrapolation too."""
    npz = turbulence3d(tmp_path / "d.npz")
    argv = ["--model", "fno3d_a", "--npz-path", npz, "--n-iters", "2",
            "--ckpt-every", "2", "--n-frames", "6", "--fno-width", "4",
            "--fno-modes", "3", "--n-coeffs", "4", "--fno-rollout-steps",
            "2", "--fno-remat"]
    with jax.enable_x64(False):
        jcli.main(argv + ["--out-dir", str(tmp_path / "j")])
    tcli.main(argv + ["--out-dir", str(tmp_path / "t"), "--device", "cpu"])
    j, t = tmp_path / "j_4", tmp_path / "t_4"
    assert sorted(os.listdir(j)) == sorted(os.listdir(t))
    a, b = np.load(j / "extrapolation.npy"), np.load(t / "extrapolation.npy")
    assert a.shape == b.shape == (8, 4, N, N, N)
    metas = [json.load(open(x / "checkpoint.npz.meta.json")) for x in (j, t)]
    assert metas[0]["grid"] == metas[1]["grid"] == [N, N, N]
    assert metas[0]["config"] == metas[1]["config"] | {
        "out_dir": metas[0]["config"]["out_dir"]}
    with np.load(npz) as d:
        umax = float(np.abs(d["u"]).max())
    reports = {}
    with jax.enable_x64(False):
        for name, mod, extra in (("jax", jeval, []),
                                 ("port", teval, ["--device", "cpu"])):
            out = str(tmp_path / f"{name}.json")
            mod.main(["--ckpt", str(j), "--npz-path", npz, "--physics",
                      "--json", out] + extra)
            with open(out) as f:
                reports[name] = json.load(f)
        _reports_close(reports["port"], reports["jax"], umax)
        argv = ["--extrapolation", str(t / "extrapolation.npy"),
                "--npz-path", npz, "--physics", "--n-frames", "6"]
        rep = teval.main(argv + ["--device", "cpu"])
        jeval.main(argv + ["--json", str(tmp_path / "x.json")])
    with open(tmp_path / "x.json") as f:
        _reports_close(json.loads(json.dumps(rep)), json.load(f), umax)
    assert rep["physics"]["divergence_max_pred"] <= 1e-5 * umax


_NO_JAX = """
import json, sys
import numpy as np
from ns_tpu_torch.solvers import spectral3d as s3
cfg = s3.Spectral3DConfig(nx=8, ny=8, nz=8, dt=0.01, nu=1e-2)
u = s3.simulate_strided(cfg, s3.random_solenoidal_velocity(cfg, k_peak=2.0),
                        5, device="cpu")
np.savez("d.npz", **{k: f.numpy() for k, f in zip("uvwp", u)})
from ns_tpu_torch.cli import evaluate, train
train.main(["--model", "fno3d_a", "--npz-path", "d.npz", "--n-iters", "2",
            "--n-frames", "4", "--fno-width", "4", "--fno-modes", "3",
            "--device", "cpu", "--out-dir", "a"])
rep = evaluate.main(["--ckpt", "a_10", "--npz-path", "d.npz", "--physics",
                     "--device", "cpu"])
print(json.dumps({"jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "ns_tpu")),
                  "physics": sorted(rep["physics"])}))
"""


def test_3d_path_imports_no_jax(tmp_path):
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", _NO_JAX],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "jax": [], "physics": ["divergence_max_obs", "divergence_max_pred",
                               "spectrum_rel_l2"]}
