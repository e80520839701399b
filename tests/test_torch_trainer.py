"""The port's training objective (ns_tpu_torch.train.trainer: build_model,
build_forward, l2_loss, autograd) against ns_tpu's (build_forward +
l2_loss + jax.value_and_grad), and the Trainer's checks, on the CPU.

Tolerances: the loss and every parameter's gradient in float64 <= 1e-10
relative (the loss to itself, the gradients to max|grad| over all
parameters), from the same parameters carried by key path
(`params_from_jax`) and the same numpy observations; the same sums in
another order differ at ~1e-15. Remat equals no remat bitwise. The FNO
cases run at both spectral engines, and again with the spectral weights
at scale 1 (random complex weights, whose mixed spectra are not
Hermitian: the fft engine trains through the port's non-Hermitian
`irfft2`, autograd's derivative of its composition, against JAX's own
transpose rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.models.vorticity import vorticity_from_uv as jax_vorticity
from ns_tpu.serve.engine import _build_model as jax_build
from ns_tpu.train import trainer as jtr
from ns_tpu.train.checkpoint import _flatten_with_paths
from ns_tpu.train.metrics import l2_loss as jax_l2
from ns_tpu_torch.train import trainer as ttr
from ns_tpu_torch.train.checkpoint import (jax_key, params_from_jax,
                                           params_to_jax)
from ns_tpu_torch.train.metrics import l2_loss

N, NT = 16, 6
BASIS = ["basis_ode", "basis_ode2", "basis_gru", "basis_ode_conv", "rnn"]
FNO = ["fno", "fno_w", "fno_psi"]
CASES = ([(m, "auto", False, {}) for m in BASIS]
         + [(m, t, s, {}) for m in FNO for t in ("fft", "matmul")
            for s in (False, True)]
         + [("fno", "matmul", False, dict(fno_rollout_steps=2)),
            ("fno", "fft", True, dict(fno_rollout_steps=2,
                                      fno_project=True)),
            ("fno", "matmul", False, dict(fno_rollout_steps=2,
                                          fno_remat=True)),
            ("fno_w", "matmul", True, dict(fno_rollout_steps=2)),
            ("fno_w", "fft", False, dict(fno_rollout_steps=2,
                                         fno_dealias=False)),
            ("fno_psi", "fft", False, dict(fno_rollout_steps=2))])


def configs(model, transform="auto", **kw):
    kw = dict(model=model, n_coeffs=2, hidden_dim=16, fno_width=4,
              fno_modes=5, fno_transform=transform, **kw)
    return jtr.TrainConfig(**kw), ttr.TrainConfig(**kw)


def observations(m=1, seed=1):
    return np.random.default_rng(seed).normal(size=(NT, m, 3, N, N))


def port_loss_and_grads(tcfg, flat, obs):
    model = ttr.build_model(tcfg, N, N, dtype=torch.float64)
    params_from_jax(model, flat)
    tobs = torch.tensor(obs)
    frames, _ = ttr.training_tensors(tcfg, tobs)
    loss = l2_loss(*ttr.build_forward(tcfg, frames)(model))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), {jax_key(n): g.numpy()
                                  for (n, _), g in zip(named, grads)}


@pytest.mark.parametrize("model,transform,scale1,kw", CASES)
def test_objective_and_gradient_match_jax(model, transform, scale1, kw):
    jcfg, tcfg = configs(model, transform, **kw)
    jm = jax_build(jcfg, N, N)
    p = jm.init(jax.random.PRNGKey(0))
    if scale1:
        p["spectral"] = [{k: v * jcfg.fno_width ** 2 for k, v in s.items()}
                         for s in p["spectral"]]
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), p)
    obs = observations()
    jobs = jnp.asarray(obs)
    wf = (jax_vorticity(jobs[:, :, 0], jobs[:, :, 1])[:, :, None]
          if model == "fno_w" else None)
    fwd = jtr.build_forward(jcfg, jm, jobs, wf, 1.0)
    jl, jg = jax.jit(jax.value_and_grad(lambda q: jax_l2(*fwd(q))))(p)
    jg = _flatten_with_paths(jg)
    loss, grads = port_loss_and_grads(tcfg, _flatten_with_paths(p), obs)
    assert sorted(grads) == sorted(jg)
    assert abs(loss - float(jl)) <= 1e-10 * abs(float(jl))
    gmax = max(float(np.abs(v).max()) for v in jg.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g, jg[k], rtol=0, atol=1e-10 * gmax,
                                   err_msg=k)


def test_remat_equals_no_remat():
    _, plain = configs("fno_w", "matmul", fno_rollout_steps=3)
    _, remat = configs("fno_w", "matmul", fno_rollout_steps=3,
                       fno_remat=True)
    flat = params_to_jax(ttr.build_model(
        plain, N, N, dtype=torch.float64,
        generator=torch.Generator().manual_seed(0)))
    a = port_loss_and_grads(plain, flat, observations())
    b = port_loss_and_grads(remat, flat, observations())
    assert a[0] == b[0]
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])


def test_noise_and_minibatch_draw_from_the_generator():
    """batch_size windows drawn with replacement, then noise of std
    input_noise * data_scale on the first input; no generator draws
    neither."""
    _, cfg = configs("fno", batch_size=3, input_noise=0.5)
    obs = torch.tensor(observations())
    fwd = ttr.build_forward(cfg, obs, data_scale=2.0)
    model = lambda x: x  # noqa: E731
    gen = torch.Generator().manual_seed(5)
    pred, target = fwd(model, gen)
    g2 = torch.Generator().manual_seed(5)
    idx = torch.randint(0, NT - 1, (3,), generator=g2)
    noise = 0.5 * 2.0 * torch.randn(pred.shape, generator=g2,
                                    dtype=pred.dtype)
    torch.testing.assert_close(pred, obs[idx] + noise, rtol=0, atol=0)
    torch.testing.assert_close(target, obs[idx + 1], rtol=0, atol=0)
    pred, target = fwd(model)
    torch.testing.assert_close(pred, obs[:-1], rtol=0, atol=0)


# --- the Trainer's checks: raised where the JAX Trainer raises ------------


def write_data(path, m=1, nt=NT):
    obs = observations(m)
    if m == 1:
        u, v, p = (obs[:, 0, i] for i in range(3))
    else:
        u, v, p = (np.swapaxes(obs[:, :, i], 0, 1) for i in range(3))
    np.savez(path, u=u, v=v, p=p)
    return str(path)


@pytest.mark.parametrize("model,m,kw,exc", [
    ("basis_ode", 2, {}, ValueError),           # multi-trajectory basis
    ("fno", 1, dict(fno_rollout_steps=NT), ValueError),
    ("fno", 1, dict(fno_rollout_steps=0), ValueError),
    ("fno_w", 1, dict(input_noise=-0.1), ValueError),
    ("fno3d", 1, {}, ValueError),               # 3D family on 2D data
])
def test_trainer_checks_raise_where_jax_raises(tmp_path, model, m, kw, exc):
    npz = write_data(tmp_path / "d.npz", m)
    kw = dict(model=model, npz_path=npz, out_dir=str(tmp_path / "o"),
              n_frames=NT, fno_width=4, fno_modes=3, n_coeffs=2, **kw)
    with pytest.raises(exc):
        jtr.Trainer(jtr.TrainConfig(**kw))
    with pytest.raises(exc):
        ttr.Trainer(ttr.TrainConfig(**kw), device="cpu")


@pytest.mark.parametrize("kw", [dict(batch_size=2, model="basis_ode"),
                                dict(n_iters=-1), dict(ckpt_every=0),
                                dict(grad_clip=-1.0),
                                dict(lr_schedule="step"),
                                dict(warmup_iters=-1)])
def test_config_checks_raise_where_jax_raises(kw):
    with pytest.raises(ValueError):
        jtr.TrainConfig(**kw)
    with pytest.raises(ValueError):
        ttr.TrainConfig(**kw)


def test_trainer_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    from ns_tpu_torch.core.device import NO_CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttr.TrainConfig(model="fno", npz_path=write_data(
        tmp_path / "d.npz"), fno_width=4, fno_modes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.Trainer(cfg)
    assert "device" in NO_CUDA
    obs = observations()
    npz3 = str(tmp_path / "d3.npz")
    np.savez(npz3, **{k: np.repeat(obs[:, 0, i % 3, :, :, None], 4, axis=-1)
                      for i, k in enumerate("uvwp")})
    cfg3 = ttr.TrainConfig(model="fno3d", npz_path=npz3, fno_width=4,
                           fno_modes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.Trainer(cfg3)
    assert ttr.Trainer(cfg3, device="cpu").model.nz == 4


def test_basis_training_lowers_the_loss(tmp_path):
    """A basis family trained on the CPU for a few dozen iterations."""
    npz = write_data(tmp_path / "d.npz")
    cfg = ttr.TrainConfig(model="basis_ode", npz_path=npz, n_coeffs=3,
                          n_frames=NT, n_iters=30, ckpt_every=10, lr=1e-2,
                          out_dir=str(tmp_path / "o"))
    losses = ttr.Trainer(cfg, device="cpu").train(progress=False)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-1] < 0.9 * losses[0]


def test_training_after_inference_mode():
    """Tables cached by a rollout under torch.inference_mode (serving) are
    saved for a later backward (training) in the same process."""
    _, cfg = configs("fno_w", "matmul", fno_rollout_steps=2)
    model = ttr.build_model(cfg, 24, 24, generator=torch.Generator()
                            .manual_seed(0))
    obs = torch.randn(4, 1, 3, 24, 24)
    with torch.inference_mode():
        ttr.extrapolate_model(cfg, model, obs)
    frames, _ = ttr.training_tensors(cfg, obs)
    loss = l2_loss(*ttr.build_forward(cfg, frames)(model))
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
