"""The port's differentiable rollouts (ns_tpu_torch.solvers.diffable)
against ns_tpu's, float64 on the CPU at 16^2.

Tolerances: the gradient through an 8-step rollout <= 1e-10 relative to
`jax.grad`'s (torch takes conjugate-Wirtinger gradients through the complex
intermediates; for a real loss of a real input that is the real gradient);
the chunked-remat rollout equal to the plain one (value rtol 1e-12,
gradients atol 1e-12, as tests/test_diffable.py); fit_initial_vorticity's
losses <= 1e-8 relative to JAX's over 10 iterations (the losses fall ~20x
an iteration, so the relative difference grows from ~1e-16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.solvers import diffable as jd
from ns_tpu.solvers import spectral_periodic as js
from ns_tpu_torch.solvers import diffable as td
from ns_tpu_torch.solvers import spectral_periodic as ts

KW = dict(nt=8, nx=16, ny=16, dt=0.005, nu=1e-2, dtype="float64")


def jax_loss(cfg, target, chunk=0):
    ops = js.make_ops(cfg)
    step_pair, _ = js.make_step(cfg)
    step = lambda c: step_pair(c)[0]

    def loss(w0):
        h = jnp.fft.rfft2(w0)
        carry = (h, js.nonlinear_term(h, ops, cfg))
        final = (jd.rollout_chunked_remat(step, carry, cfg.nt, chunk) if chunk
                 else jd.rollout_final(step, carry, cfg.nt))
        w_fin = jnp.fft.irfft2(final[0], s=(cfg.nx, cfg.ny))
        return jnp.mean((w_fin - target) ** 2)

    return loss


def torch_loss(cfg, target, chunk=0):
    ops = ts.make_ops(cfg, "cpu")
    transforms = ts.make_transforms(cfg, "cpu")
    step_pair, _ = ts.make_step(cfg, "cpu")
    step = lambda c: step_pair(c)[0]
    target = torch.as_tensor(target)

    def loss(w0):
        h = torch.fft.rfft2(w0)
        carry = (h, ts.nonlinear_term(h, ops, cfg, transforms))
        final = (td.rollout_chunked_remat(step, carry, cfg.nt, chunk) if chunk
                 else td.rollout_final(step, carry, cfg.nt))
        w_fin = torch.fft.irfft2(final[0], s=(cfg.nx, cfg.ny))
        return torch.mean((w_fin - target) ** 2)

    return loss


def value_and_grad(loss, w0):
    w = torch.tensor(w0, requires_grad=True)
    val = loss(w)
    (g,) = torch.autograd.grad(val, w)
    return float(val.detach()), g.numpy()


@pytest.mark.parametrize("engine", [dict(transform="fft"),
                                    dict(transform="matmul",
                                         matmul_precision="highest")],
                         ids=["fft", "matmul"])
def test_gradient_through_rollout_matches_jax(engine):
    jc = js.SpectralPeriodicConfig(**KW, **engine)
    tc = ts.SpectralPeriodicConfig(**KW, **engine)
    target = ts.taylor_green_vorticity(tc)
    w0 = np.random.default_rng(0).normal(size=(16, 16)) * 0.1
    v_j, g_j = jax.value_and_grad(jax_loss(jc, target))(jnp.asarray(w0))
    v_t, g_t = value_and_grad(torch_loss(tc, target), w0)
    g_j = np.asarray(g_j)
    assert abs(v_t - float(v_j)) <= 1e-12 * abs(float(v_j))
    assert np.abs(g_t - g_j).max() <= 1e-10 * np.abs(g_j).max()
    assert np.abs(g_j).max() > 0


def test_chunked_remat_same_values_and_grads():
    tc = ts.SpectralPeriodicConfig(**KW)
    target = ts.taylor_green_vorticity(tc)
    w0 = np.random.default_rng(0).normal(size=(16, 16)) * 0.1
    v1, g1 = value_and_grad(torch_loss(tc, target), w0)
    v2, g2 = value_and_grad(torch_loss(tc, target, chunk=4), w0)
    np.testing.assert_allclose(v1, v2, rtol=1e-12)
    np.testing.assert_allclose(g1, g2, atol=1e-12)
    with pytest.raises(ValueError, match="divisible"):
        td.rollout_chunked_remat(lambda s: s, torch.zeros(1), 8, 3)


def fit_case():
    kw = dict(nt=10, nx=16, ny=16, dt=0.01, nu=1e-2, dtype="float64")
    jc, tc = js.SpectralPeriodicConfig(**kw), ts.SpectralPeriodicConfig(**kw)
    w_true = ts.taylor_green_vorticity(tc)
    fin = ts.rollout_final(tc, ts.init_from_vorticity(tc, w_true, "cpu"))
    target = torch.fft.irfft2(fin[0], s=(16, 16)).numpy()
    return jc, tc, target


@pytest.mark.parametrize("chunk", [0, 5])
def test_fit_initial_vorticity_losses_match_jax(chunk):
    jc, tc, target = fit_case()
    _, l_j = jd.fit_initial_vorticity(jc, target, nt=10, n_iters=10,
                                      lr=100.0, chunk=chunk)
    w_t, l_t = td.fit_initial_vorticity(tc, target, nt=10, n_iters=10,
                                        lr=100.0, chunk=chunk, device="cpu")
    assert len(l_t) == 10 and w_t.shape == (16, 16)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-8)


def test_fit_initial_vorticity_converges():
    """Adjoint data assimilation: recover an initial condition whose
    rollout hits the (decayed) Taylor-Green target; the target's tensor
    sets the device."""
    _, tc, target = fit_case()
    w0, losses = td.fit_initial_vorticity(tc, torch.as_tensor(target),
                                          nt=10, n_iters=40, lr=100.0)
    assert w0.device.type == "cpu"
    assert losses[-1] < losses[0] * 1e-2, losses[::10]
