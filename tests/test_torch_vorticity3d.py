"""The port's 3D representation adapters and rollout filters
(ns_tpu_torch.models.vorticity3d, the 3D half of models.projection)
against ns_tpu's, in float64 on the CPU from the same numpy inputs.

Tolerance: <= 1e-12 of each output's scale (the same FFT sums in another
order differ at ~1e-15). The JAX adapters take dtype="float64" (their
default float32 tables round 1/k^2; the port builds its tables in the
input's dtype) and are vmapped over the batch the port takes as leading
axes. Inputs are random fields, not band-limited: their Nyquist planes
make i*k spectra that are not Hermitian, which the port inverts with
`spectral3d.irfft3`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.models import projection as jp
from ns_tpu.models import vorticity3d as jv
from ns_tpu_torch.models import projection as tp
from ns_tpu_torch.models import vorticity3d as tv
from ns_tpu_torch.solvers import spectral3d as ts3

# even, odd and mixed grids
SHAPES = [(12, 10, 8), (9, 10, 7), (8, 8, 8)]


def rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def close(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


ADAPTERS = {
    "vorticity3d_from_velocity": lambda m: m.vorticity3d_from_velocity,
    "vecpot_from_velocity": lambda m: m.vecpot_from_velocity,
    "uvwp_from_omega": lambda m: m.uvwp_from_omega,
    "uvwp_from_vecpot": lambda m: m.uvwp_from_vecpot,
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(ADAPTERS))
def test_adapters_match_jax(name, shape):
    x = rand(2, 3, *shape)
    jfn = functools.partial(ADAPTERS[name](jv), dtype="float64")
    want = jax.vmap(jfn)(jnp.asarray(x))
    close(ADAPTERS[name](tv)(torch.tensor(x)).numpy(), want)


@pytest.mark.parametrize("model", ["fno3d_w", "fno3d_a"])
def test_repr3d_fns_pair_as_jax(model):
    x = rand(3, 10, 8, 9, seed=1)
    to_r, to_u = tv.repr3d_fns(model)
    jr, ju = jv.repr3d_fns(model)
    assert (to_r.__name__, to_u.__name__) == (jr.__name__, ju.__name__)
    r = to_r(torch.tensor(x))
    close(r.numpy(), jr(jnp.asarray(x), dtype="float64"))
    close(to_u(r).numpy(), ju(jnp.asarray(r.numpy()), dtype="float64"))


@pytest.mark.parametrize("shape", SHAPES)
def test_dealias_field3d_matches_jax(shape):
    x = rand(2, 4, *shape, seed=2)
    close(tv.dealias_field3d(torch.tensor(x)).numpy(),
          jv.dealias_field3d(jnp.asarray(x)))


@pytest.mark.parametrize("shape", SHAPES)
def test_project_leray3d_matches_jax(shape):
    u, v, w = (rand(2, *shape, seed=s) for s in (3, 4, 5))
    got = tp.project_leray3d(*map(torch.tensor, (u, v, w)))
    want = jp.project_leray3d(*map(jnp.asarray, (u, v, w)))
    for g, h in zip(got, want):
        close(g.numpy(), h)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("project,dealias", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_rollout_filter3d_matches_jax(project, dealias, shape):
    x = rand(2, 4, *shape, seed=6)
    got = tp.rollout_filter3d(torch.tensor(x), project=project,
                              dealias=dealias)
    want = jp.rollout_filter3d(jnp.asarray(x), project=project,
                               dealias=dealias)
    close(got.numpy(), want)


def spectral_div(u):
    """max |k . u_hat| over the paired modes (the Nyquist wavenumbers
    zeroed, as the projection does), numpy float64."""
    nx, ny, nz = u.shape[-3:]
    kx, ky = np.fft.fftfreq(nx, 1.0 / nx), np.fft.fftfreq(ny, 1.0 / ny)
    kz = np.fft.rfftfreq(nz, 1.0 / nz)
    for k, n in ((kx, nx), (ky, ny)):
        if n % 2 == 0:
            k[n // 2] = 0.0
    if nz % 2 == 0:
        kz[-1] = 0.0
    uh = np.fft.rfftn(u, axes=(-3, -2, -1))
    return np.abs(kx[:, None, None] * uh[..., 0, :, :, :]
                  + ky[None, :, None] * uh[..., 1, :, :, :]
                  + kz[None, None, :] * uh[..., 2, :, :, :]).max()


@pytest.mark.parametrize("model", ["fno3d_w", "fno3d_a"])
def test_recovery_is_divergence_free_for_any_field(model):
    """Any predicted field recovers an exactly solenoidal velocity."""
    x = torch.tensor(rand(2, 3, 12, 10, 8, seed=7))
    u = tv.repr3d_fns(model)[1](x)[:, :3].numpy()
    scale = np.abs(np.fft.rfftn(u, axes=(-3, -2, -1))).max()
    assert spectral_div(u) <= 1e-12 * scale


def test_irfft3_is_irfftn_on_hermitian_spectra_and_numpy_on_any():
    """On a real field's spectrum irfft3 equals torch.fft.irfftn bitwise
    (the solver's inverse); on any half spectrum it is numpy's irfftn."""
    for dtype in (torch.float32, torch.float64):
        x = torch.tensor(rand(2, 9, 10, 8, seed=8)).to(dtype)
        z = torch.fft.rfftn(x, dim=(-3, -2, -1))
        assert torch.equal(ts3.irfft3(z, x.shape[-3:]),
                           torch.fft.irfftn(z, s=x.shape[-3:],
                                            dim=(-3, -2, -1)))
    z = rand(2, 10, 8, 6, 2, seed=9)
    z = z[..., 0] + 1j * z[..., 1]
    close(ts3.irfft3(torch.tensor(z), (10, 8, 10)).numpy(),
          np.fft.irfftn(z, s=(10, 8, 10), axes=(-3, -2, -1)))
