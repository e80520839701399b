"""The port's surrogate building blocks and non-FNO families
(ns_tpu_torch.models: layers, node, basis, gru) against ns_tpu's, in
float64 on the CPU, from the same parameters carried by key path
(`train/checkpoint.py::params_from_jax`) and the same numpy inputs.

Tolerance: <= 1e-10 of each output's scale (the same sums taken in
another order differ at ~1e-15); gradients likewise. The init draws are
held to the JAX init's distributions, not its values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.models import basis as jb
from ns_tpu.models import gru as jg
from ns_tpu.models import layers as jl
from ns_tpu.models import node as jn
from ns_tpu.train import metrics as jmet
from ns_tpu.train.checkpoint import _flatten_with_paths
from ns_tpu_torch.models import basis as tb
from ns_tpu_torch.models import gru as tg
from ns_tpu_torch.models import layers as tl
from ns_tpu_torch.models import node as tn
from ns_tpu_torch.train import metrics as tmet
from ns_tpu_torch.train.checkpoint import params_from_jax, params_to_jax


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def carry(jax_params, model: torch.nn.Module) -> torch.nn.Module:
    """The JAX parameter tree into the float64 torch model; every leaf of
    each side must have its counterpart."""
    flat = _flatten_with_paths(f64(jax_params))
    model = params_from_jax(model.double(), flat)
    assert set(params_to_jax(model)) == set(flat)
    return model


def npy(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, rel=1e-10):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("w_std", [None, 0.1])
def test_dense(w_std):
    p = jl.dense_init(jax.random.PRNGKey(0), 5, 7, w_std=w_std)
    d = carry(p, tl.Dense(5, 7, w_std=w_std))
    x = rand(3, 4, 5)
    close(d(torch.tensor(x)), jl.dense(f64(p), jnp.asarray(x)))
    h = rand(2, 5, 6, 4, seed=1)  # channels on axis -3
    want = jnp.moveaxis(jl.dense(f64(p), jnp.moveaxis(jnp.asarray(h), -3,
                                                      -1)), -1, -3)
    close(d.channels(torch.tensor(h)), want)


def test_gru_cell_and_its_input_projection():
    p = jl.gru_init(jax.random.PRNGKey(1), 6, 4)
    cell = carry(p, tl.GRUCell(6, 4))
    h, x = rand(3, 4), rand(3, 6, seed=1)
    want = jl.gru_cell(f64(p), jnp.asarray(h), jnp.asarray(x))
    close(cell(torch.tensor(h), torch.tensor(x)), want)
    gi = jnp.asarray(x) @ f64(p)["w_ih"] + f64(p)["b_ih"]
    close(cell.step(torch.tensor(h), torch.tensor(np.asarray(gi))), want)


def test_gru_cell_is_torch_grucell_transposed():
    """w_ih (in, 3H) and w_hh (H, 3H) hold the gates r, z, n: torch.nn.
    GRUCell's weights transposed."""
    cell = tl.GRUCell(6, 4, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.GRUCell(6, 4)
    with torch.no_grad():
        ref.weight_ih.copy_(cell.w_ih.T)
        ref.weight_hh.copy_(cell.w_hh.T)
        ref.bias_ih.copy_(cell.b_ih)
        ref.bias_hh.copy_(cell.b_hh)
    h, x = torch.randn(3, 4), torch.randn(3, 6)
    torch.testing.assert_close(cell(h, x), ref(x, h), rtol=1e-6, atol=1e-6)


def test_init_draws_the_jax_distributions():
    """uniform(+-1/sqrt(in)) dense, N(0, w_std) with zero bias, uniform
    (+-1/sqrt(H)) GRU, scale * N(0, 1) spectral weights, N(0, 1) basis;
    `generator` makes a draw reproducible."""
    from ns_tpu_torch.models.fno import FNO2D

    g = lambda: torch.Generator().manual_seed(3)
    with torch.no_grad():
        d = tl.Dense(400, 300, generator=g())
        bound = 1.0 / 20.0
        assert float(d.w.abs().max()) <= bound
        assert float(d.b.abs().max()) <= bound
        assert abs(float(d.w.std()) - bound / np.sqrt(3)) < 0.02 * bound
        torch.testing.assert_close(d.w, tl.Dense(400, 300, generator=g()).w)
        n = tl.Dense(400, 300, w_std=0.1, generator=g())
        assert abs(float(n.w.std()) - 0.1) < 2e-3 and not n.b.any()
        cell = tl.GRUCell(50, 64, generator=g())
        for t in (cell.w_ih, cell.w_hh, cell.b_ih, cell.b_hh):
            assert float(t.abs().max()) <= 1.0 / 8.0
        fno = FNO2D(32, 32, width=16, modes=8, generator=g())
        s = fno.spectral[0].lo_re
        assert abs(float(s.std()) * 256 - 1.0) < 0.05
        m = tb.BasisODE(3, 16, 16, generator=g())
        assert abs(float(m.basis.std()) - 1.0) < 0.05


# --- node --------------------------------------------------------------------

def _field(seed=0, dim=6):
    p = jb.mlp_field_init(jax.random.PRNGKey(seed), dim, hidden=16)
    return p, carry(p, tb.MLPField(dim, hidden=16))


@pytest.mark.parametrize("method", ["Euler", "RK2", "RK4"])
def test_odeint(method):
    p, field = _field()
    z0 = rand(2, 6)
    want = jn.odeint(lambda t, z: jb.mlp_field_apply(f64(p), z),
                     jnp.asarray(z0), 7, method)
    got = tn.odeint(lambda t, z: field(z), torch.tensor(z0), 7, method)
    close(got, want)
    got = tn.odesolver(lambda t, z: field(z), torch.tensor(z0),
                       {"Nt": 7, "method": method})
    close(got, want)


def test_odeint_rejects_unknown_method():
    with pytest.raises(ValueError, match="method"):
        tn.odeint(lambda t, z: z, torch.zeros(2), 3, "RK3")


def test_odeint_checkpoint_values_and_gradients():
    """The recompute adjoint gives odeint's values and gradients (to z0 and
    to the field's parameters), and JAX's gradients."""
    p, field = _field(seed=1)
    z0 = rand(2, 6, seed=2)

    def port(integrate):
        z = torch.tensor(z0, requires_grad=True)
        out = integrate(lambda t, y: field(y), z, 5, "RK4")
        loss = (out ** 2).sum()
        grads = torch.autograd.grad(loss, [z, field.l1.w, field.l3.b])
        return out.detach(), grads

    (a, ga), (b, gb) = port(tn.odeint), port(tn.odeint_checkpoint)
    close(b, a)
    for x, y in zip(gb, ga):
        close(x, y)

    def loss(pp, z):
        return jnp.sum(jn.odeint_checkpoint(
            lambda t, y: jb.mlp_field_apply(pp, y), z, 5, "RK4") ** 2)

    gp, gz = jax.grad(loss, argnums=(0, 1))(f64(p), jnp.asarray(z0))
    close(gb[0], gz)
    close(gb[1], gp["l1"]["w"])
    close(gb[2], gp["l3"]["b"])
    close(tn.odesolver_adjoint(lambda t, y: field(y), torch.tensor(z0),
                               {"Nt": 5}).detach(), a)


# --- basis families ----------------------------------------------------------

BASIS = {
    "basis_ode": (jb.BasisODE, tb.BasisODE),
    "basis_ode2": (jb.BasisODE2, tb.BasisODE2),
    "basis_gru": (jb.BasisGRU, tb.BasisGRU),
    "basis_ode_conv": (jb.BasisODEConv, tb.BasisODEConv),
}


@pytest.mark.parametrize("name", list(BASIS))
def test_basis_family(name):
    jcls, tcls = BASIS[name]
    K, nx, ny, nt = 3, 6, 5, 4
    jm, tm = jcls(K, nx, ny), tcls(K, nx, ny)
    p = jm.init(jax.random.PRNGKey(2))
    tm = carry(p, tm)
    grid0 = rand(2, 3, nx, ny, seed=3)
    want = jm.apply(f64(p), jnp.asarray(grid0), nt)
    got = tm(torch.tensor(grid0), nt)
    assert got.shape == (nt, 2, 3, nx, ny)
    close(got, want)
    if hasattr(jm, "diversity_penalty"):
        close(tm.diversity_penalty(), jm.diversity_penalty(f64(p)))


def test_diversity_penalty():
    W = rand(5, 12, seed=4)
    close(tb.diversity_penalty(torch.tensor(W)),
          jb.diversity_penalty(jnp.asarray(W)))


# --- full-field GRU ----------------------------------------------------------

def test_full_field_gru_forward_and_extrapolate():
    D, H = 3 * 4 * 5, 8
    jm = jg.FullFieldGRU(D, H)
    p = jm.init(jax.random.PRNGKey(5))
    tm = carry(p, tg.FullFieldGRU(D, H))
    seq = rand(2, 6, D, seed=5)
    close(tm(torch.tensor(seq)), jm.apply(f64(p), jnp.asarray(seq)))
    close(tm.extrapolate(torch.tensor(seq[:, 0]), 5),
          jm.extrapolate(f64(p), jnp.asarray(seq[:, 0]), 5))
    assert tm.extrapolate(torch.tensor(seq[:, 0]), 0).shape == (2, 0, D)


# --- metrics -----------------------------------------------------------------

def test_metrics_match_jax():
    a, b = rand(3, 5, 7, seed=6), rand(3, 5, 7, seed=7)
    ta, tb_ = torch.tensor(a), torch.tensor(b)
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    close(tmet.l2_loss(ta, tb_), jmet.l2_loss(ja, jb_))
    close(tmet.mean_squared_error(ta, tb_), jmet.mean_squared_error(ja, jb_))
    close(tmet.log_normal_pdf(ta, tb_, ta * 0.1),
          jmet.log_normal_pdf(ja, jb_, ja * 0.1))
    close(tmet.normal_kl(ta, tb_ * 0.1, tb_, ta * 0.1),
          jmet.normal_kl(ja, jb_ * 0.1, jb_, ja * 0.1))
    assert tmet.rel_l2(ta, tb_) == pytest.approx(jmet.rel_l2(a, b),
                                                 rel=1e-12)
    close(tmet.divergence_residual_fd(ta[0], tb_[0], 0.1, 0.2),
          jmet.divergence_residual_fd(ja[0], jb_[0], 0.1, 0.2))
    close(tmet.kinetic_energy(ta, tb_), jmet.kinetic_energy(ja, jb_))
    m, jm = tmet.AverageMeter(), jmet.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1), (2.5, 3)):
        m.update(v, n)
        jm.update(v, n)
    assert (m.val, m.avg, m.sum, m.count) == (jm.val, jm.avg, jm.sum,
                                              jm.count)
