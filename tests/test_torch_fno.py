"""The port's FNO family and its spectral maps (ns_tpu_torch.models: fno,
streamfunction, vorticity, projection) against ns_tpu's, in float64 on
the CPU, from the same parameters carried by key path and the same numpy
inputs.

Tolerances: float64 <= 1e-10 of each output's scale (the same DFT sums in
another order differ at ~1e-15); the two engines against each other in
float32 at the JAX tests' bound, rtol 2e-4 and atol 1e-5
(tests/test_fno.py). The spectral weights are drawn at scale 1 instead of
1/width^2, so the spectral path carries the output and a fault in it
shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.models import fno as jf
from ns_tpu.models import projection as jp
from ns_tpu.models import streamfunction as jsf
from ns_tpu.models import vorticity as jv
from ns_tpu.train.checkpoint import _flatten_with_paths
from ns_tpu_torch.models import fno as tf
from ns_tpu_torch.models import projection as tp
from ns_tpu_torch.models import streamfunction as tsf
from ns_tpu_torch.models import vorticity as tv
from ns_tpu_torch.train.checkpoint import params_from_jax


def npy(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, rel=1e-10):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def models(jcls, tcls, nx, ny, seed=0, dtype=np.float64, **kw):
    """A JAX model's params (spectral weights at scale 1, cast to dtype)
    and the port's model carrying them, in the matching torch dtype."""
    jm = jcls(nx, ny, **kw)
    p = jm.init(jax.random.PRNGKey(seed))
    p["spectral"] = [{k: v * kw["width"] ** 2 for k, v in s.items()}
                     for s in p["spectral"]]
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), p)
    tm = tcls(nx, ny, **kw).to(torch.float64 if dtype == np.float64
                                else torch.float32)
    return jm, p, params_from_jax(tm, _flatten_with_paths(p))


# even and odd grids; my == ny//2 + 1 with a Nyquist column (16, 18, 10)
# and without one (16, 15, 8); a full band (12, 12, 6)
GRIDS = [(16, 16, 5), (17, 15, 8), (16, 18, 10), (12, 12, 6)]


@pytest.mark.parametrize("transform", ["fft", "matmul"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("nx,ny,modes", GRIDS)
def test_fno2d_matches_jax(transform, channels, nx, ny, modes):
    jm, p, tm = models(jf.FNO2D, tf.FNO2D, nx, ny, width=4, modes=modes,
                       depth=2, channels=channels, transform=transform)
    x = rand(2, channels, nx, ny, seed=1)
    close(tm(torch.tensor(x)), jax.jit(jm.apply)(p, jnp.asarray(x)))


@pytest.mark.parametrize("nx,ny,modes", GRIDS)
def test_spectral_engines_agree(nx, ny, modes):
    """The matmul engine computes the fft engine's layer: float64 to
    rounding, float32 at the JAX tests' bound."""
    mx, my = min(modes, nx // 2), min(modes, ny // 2 + 1)
    s = tf.SpectralWeights(4, 4, mx, my, 0.1,
                           generator=torch.Generator().manual_seed(0))
    for dtype, rtol, atol in [(torch.float64, 1e-12, 1e-12),
                              (torch.float32, 2e-4, 1e-5)]:
        W = s.to(dtype).mixing_table(dtype).detach()
        x = torch.tensor(rand(2, 4, nx, ny, seed=2), dtype=dtype)
        a = tf._spectral_conv_fft(W, x, mx, my)
        b = tf._spectral_conv_matmul(W, x, mx, my)
        assert a.dtype == b.dtype == dtype
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


def test_fno_rollout_with_dealias_post():
    """The fno_w serving rollout: the 2/3-band filter on every fed-back
    state, against JAX's rollout with its post."""
    for transform in ("fft", "matmul"):
        jm, p, tm = models(jf.FNO2D, tf.FNO2D, 12, 12, width=4, modes=4,
                           depth=2, channels=1, transform=transform)
        x = rand(2, 1, 12, 12, seed=3)
        want = jax.jit(lambda p, x: jm.rollout(
            p, x, 4, post=lambda y: jv.dealias_field(y, transform)))(
                p, jnp.asarray(x))
        got = tm.rollout(torch.tensor(x), 4,
                         post=lambda y: tv.dealias_field(y, transform))
        close(got, want)
    assert tm.rollout(torch.tensor(x), 0).shape == (0, 2, 1, 12, 12)


def test_fno_precision_and_validation():
    """'default' (bf16 inputs, fp32 sums) stays within bf16 rounding of the
    fp32 layer; bad names raise."""
    kw = dict(width=4, modes=4, depth=2, channels=1)
    for transform in ("fft", "matmul"):
        a = tf.FNO2D(12, 12, transform=transform,
                     generator=torch.Generator().manual_seed(1), **kw)
        b = tf.FNO2D(12, 12, transform=transform, precision="default", **kw)
        b.load_state_dict(a.state_dict())
        x = torch.randn(2, 1, 12, 12, generator=torch.Generator()
                        .manual_seed(2))
        with torch.no_grad():
            ya, yb = a(x), b(x)
        err = float((ya - yb).abs().max() / ya.abs().max())
        assert 0 < err < 2e-2
    with pytest.raises(ValueError, match="precision"):
        tf.FNO2D(8, 8, precision="sloppy")
    with pytest.raises(ValueError, match="transform"):
        tf.FNO2D(8, 8, transform="dft")
    with pytest.raises(ValueError, match="channels=3"):
        tsf.FNOPsi(8, 8, channels=1)
    assert tf.FNO2D(512, 512, width=2, modes=2, depth=1,
                    device="meta").transform == "matmul"
    assert tf.FNO2D(520, 16, width=2, modes=2, depth=1,
                    device="meta").transform == "fft"


@pytest.mark.parametrize("transform", ["fft", "matmul"])
@pytest.mark.parametrize("precision", [None, "high"])
def test_fno_psi_matches_jax_and_is_solenoidal(transform, precision):
    jm, p, tm = models(jsf.FNOPsi, tsf.FNOPsi, 16, 12, width=4, modes=5,
                       depth=2, transform=transform, precision=precision)
    w = tv.dealias_field(torch.tensor(rand(2, 16, 12, seed=4)), "fft")
    x = npy(torch.stack(tv.uvp_from_w(w), dim=1))
    want = jax.jit(jm.apply)(p, jnp.asarray(x))
    got = tm(torch.tensor(x))
    close(got, want)
    u, v = got[:, 0], got[:, 1]
    du = tp.project_periodic(u, v)
    close(du[0], u, rel=1e-12)
    close(du[1], v, rel=1e-12)


# --- vorticity adapters ------------------------------------------------------

@pytest.mark.parametrize("nx,ny", [(16, 16), (15, 18), (17, 13)])
def test_vorticity_adapters_match_jax(nx, ny):
    """vorticity_from_uv, uvp_from_w (batched in the port, vmapped in
    JAX), on fields with Nyquist content. The port builds its constants in
    the input's dtype; JAX in its `dtype` argument (default float32, whose
    1/k^2 is rounded to float32), so JAX is given float64."""
    u, v = rand(3, nx, ny, seed=5), rand(3, nx, ny, seed=6)
    close(tv.vorticity_from_uv(torch.tensor(u), torch.tensor(v)),
          jax.jit(lambda a, b: jv.vorticity_from_uv(a, b, "float64"))(
              jnp.asarray(u), jnp.asarray(v)))
    w = rand(2, 3, nx, ny, seed=7)
    got = tv.uvp_from_w(torch.tensor(w), rho=1.3)
    want = jax.jit(jax.vmap(lambda a: jv.uvp_from_w(a, 1.3, "float64")))(
        jnp.asarray(w.reshape(6, nx, ny)))
    for g, h in zip(got, want):
        close(g, np.asarray(h).reshape(2, 3, nx, ny))


@pytest.mark.parametrize("engine", ["fft", "matmul", "auto"])
@pytest.mark.parametrize("nx,ny", [(16, 16), (17, 15), (32, 48)])
def test_dealias_field_matches_jax(engine, nx, ny):
    w = rand(2, nx, ny, seed=8)
    close(tv.dealias_field(torch.tensor(w), engine),
          jax.jit(lambda a: jv.dealias_field(a, engine))(jnp.asarray(w)))


def test_dealias_engines_agree_and_validation():
    w = torch.tensor(rand(2, 17, 15, seed=9), dtype=torch.float32)
    torch.testing.assert_close(tv.dealias_field(w, "fft"),
                               tv.dealias_field(w, "matmul"),
                               rtol=2e-4, atol=1e-5)
    with pytest.raises(ValueError, match="engine"):
        tv.dealias_field(w, "matmull")


# --- projections -------------------------------------------------------------

@pytest.mark.parametrize("nx,ny", [(16, 16), (15, 18)])
def test_project_periodic_matches_jax(nx, ny):
    u, v = rand(2, nx, ny, seed=10), rand(2, nx, ny, seed=11)
    got = tp.project_periodic(torch.tensor(u), torch.tensor(v))
    want = jp.project_periodic(jnp.asarray(u), jnp.asarray(v))
    for g, h in zip(got, want):
        close(g, h)


def test_fd_divergences_and_project_bounded_match_jax():
    """Central and backward divergence (x along axis 1), and the bounded
    projection on a 17 x 33 grid (anisotropic spacing: the swapped
    multigrid spacings matter)."""
    u, v = rand(17, 33, seed=12), rand(17, 33, seed=13)
    dx, dy = 1.0 / 32, 1.0 / 16
    tu, tv_ = torch.tensor(u), torch.tensor(v)
    ju, jv_ = jnp.asarray(u), jnp.asarray(v)
    close(tp.divergence_central(tu, tv_, dx, dy),
          jp.divergence_central(ju, jv_, dx, dy))
    close(tp.divergence_backward(tu, tv_, dx, dy),
          jp.divergence_backward(ju, jv_, dx, dy))
    got = tp.project_bounded(tu, tv_, dx, dy, n_cycles=6)
    want = jp.project_bounded(ju, jv_, dx, dy, n_cycles=6)
    for g, h in zip(got, want):
        close(g, h, rel=1e-9)
    d0 = np.abs(npy(tp.divergence_backward(tu, tv_, dx, dy)))[1:-1, 1:-1]
    d1 = np.abs(npy(tp.divergence_backward(*got, dx, dy)))[1:-1, 1:-1]
    assert d1.max() < 1e-2 * d0.max()


def test_fno_products_never_enable_tf32(monkeypatch):
    """Precision None is fp32 with TF32 off on the card: every product of
    both engines (the complex ones too) runs with TF32 disabled, whatever
    the caller set."""
    from torch.overrides import TorchFunctionMode

    seen = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__",
                                                 "mm", "bmm"):
                seen.append(torch.backends.cuda.matmul.allow_tf32)
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for model in (tf.FNO2D(12, 12, width=4, modes=4, depth=1,
                           transform="fft"),
                  tf.FNO2D(12, 12, width=4, modes=4, depth=1,
                           transform="matmul"),
                  tsf.FNOPsi(12, 12, width=4, modes=4, depth=1)):
        with Watch(), torch.no_grad():
            model.rollout(torch.randn(2, model.channels, 12, 12), 2,
                          post=tv.dealias_field)
    assert seen and not any(seen)
