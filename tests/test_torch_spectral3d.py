"""The port's 3D spectral solver (ns_tpu_torch.solvers.spectral3d) against
ns_tpu's, in float64 on the CPU, on the same numpy inputs.

Tolerance: <= 1e-10 relative to each output's scale (the same scheme and
DFT sums, taken in another order; after 5 steps the two differ at ~1e-15).
The initial conditions are the same numpy code and are compared bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.solvers import spectral3d as j3
from ns_tpu_torch.solvers import spectral3d as t3

ENGINES = [dict(transform="fft"),
           dict(transform="matmul", matmul_precision="highest")]
SHAPES = [(16, 16, 16), (12, 18, 12)]


def cfgs(shape=(16, 16, 16), **kw):
    kw = dict(dict(zip(("nx", "ny", "nz"), shape)), dtype="float64", **kw)
    return j3.Spectral3DConfig(**kw), t3.Spectral3DConfig(**kw)


def close(got, want, rel=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_initial_conditions_bitwise():
    jc, tc = cfgs((12, 18, 12), forcing="kolmogorov", forcing_k=2)
    np.testing.assert_array_equal(t3.taylor_green_velocity(tc, k=2),
                                  np.asarray(j3.taylor_green_velocity(jc, 2)))
    np.testing.assert_array_equal(
        t3.random_solenoidal_velocity(tc, seed=4, k_peak=3.0),
        np.asarray(j3.random_solenoidal_velocity(jc, seed=4, k_peak=3.0)))
    np.testing.assert_array_equal(
        t3.kolmogorov_fixed_point_velocity(tc),
        np.asarray(j3.kolmogorov_fixed_point_velocity(jc)))
    f32 = t3.Spectral3DConfig(nx=8, ny=8, nz=8)
    assert t3.taylor_green_velocity(f32).dtype == np.float32


@pytest.mark.parametrize("engine", ENGINES, ids=["fft", "matmul"])
def test_one_step_from_a_jax_carry(engine):
    """A JAX carry brought over with carry_from_numpy steps alike."""
    jc, tc = cfgs(**engine)
    u0 = t3.random_solenoidal_velocity(tc, seed=2, k_peak=3.0)
    step_j, _ = j3.make_step(jc)
    c1 = jax.jit(lambda c: step_j(c)[0])(j3.init_from_velocity(jc, u0))
    want = t3.carry_to_numpy(jax.jit(lambda c: step_j(c)[0])(c1))
    carried = t3.carry_from_numpy(tc, t3.carry_to_numpy(c1), device="cpu")
    assert carried[0].dtype == torch.complex128
    step_t, _ = t3.make_step(tc)
    got = t3.carry_to_numpy(step_t(carried)[0])
    for g, w in zip(got, want):
        close(g, w)


def test_carry_from_numpy_needs_a_card_or_device_cpu(monkeypatch):
    """A host carry goes to the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t3.Spectral3DConfig(nx=8, ny=8, nz=8)
    host = (np.zeros((3, 8, 8, 5), np.complex64),) * 2
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t3.carry_from_numpy(cfg, host)
    assert t3.carry_from_numpy(cfg, host, "cpu")[0].device.type == "cpu"

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("engine", ENGINES, ids=["fft", "matmul"])
def test_rollout_final_and_diagnostics_match_jax(shape, engine):
    """5 steps of decaying turbulence, then energy, enstrophy,
    divergence_max and energy_spectrum of the final state."""
    jc, tc = cfgs(shape, nt=5, dt=2e-3, nu=1e-2, **engine)
    u0 = t3.random_solenoidal_velocity(tc, seed=1, k_peak=3.0)
    fin_j = jax.jit(lambda c: j3.rollout_final(jc, c))(
        j3.init_from_velocity(jc, u0))
    fin_t = t3.rollout_final(tc, t3.init_from_velocity(tc, u0, "cpu"))
    for g, w in zip(t3.carry_to_numpy(fin_t), t3.carry_to_numpy(fin_j)):
        close(g, w)
    uj, ut = fin_j[0], fin_t[0]
    for name in ("energy", "enstrophy"):
        close(getattr(t3, name)(tc, ut), getattr(j3, name)(jc, uj))
    # ~1e-16 by construction: compare against the velocity's scale
    div_t = float(t3.divergence_max(tc, ut))
    div_j = float(j3.divergence_max(jc, uj))
    assert div_t < 1e-12 and div_j < 1e-12
    k_t, e_t = t3.energy_spectrum(tc, ut)
    k_j, e_j = j3.energy_spectrum(jc, uj)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    close(e_t, e_j)


def test_fields_pressure_and_simulate_strided_frames_match_jax():
    """simulate_strided's frame semantics (frame i = state after
    1 + spinup + i*stride steps) and its u/v/w/p against the JAX one, and
    NavierStokesSystem3D.simulate against the JAX wrapper."""
    jc, tc = cfgs((12, 18, 12), nt=3, dt=2e-3, nu=1e-2, transform="matmul",
                  matmul_precision="highest", forcing="kolmogorov",
                  forcing_k=2)
    u0 = t3.random_solenoidal_velocity(tc, seed=5, k_peak=3.0)
    want = jax.jit(lambda u: j3.simulate_strided(jc, u, 3, stride=2,
                                                 spinup=1))(jnp.asarray(u0))
    got = t3.simulate_strided(tc, u0, 3, stride=2, spinup=1, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (3, 12, 18, 12)
        close(g, w)
    # frame 2 is the state after 1 + 1 + 2*2 = 6 steps
    carry = t3.init_from_velocity(tc, u0, "cpu")
    step, _ = t3.make_step(tc)
    for _ in range(6):
        carry, _ = step(carry)
    close(got[0][2], t3.fields_from_hat(tc, carry[0])[0], 1e-13)
    close(got[3][2], t3.pressure_from_hat(tc, carry[0]), 1e-13)
    kw = dict(nt=3, nx=12, ny=18, nz=12, dt=2e-3, nu=1e-2, dtype="float64",
              transform="fft")
    sim_t = t3.NavierStokesSystem3D(u0, device="cpu", **kw).simulate()
    sim_j = j3.NavierStokesSystem3D(u0, **kw).simulate()
    for g, w in zip(sim_t, sim_j):
        close(g, w)


def test_shear_flow_exact_viscous_decay():
    """u = (sin z, 0, 0): the projection annihilates the nonlinearity, so
    IF-AB2 decays by exactly exp(-nu t) (tests/test_spectral3d.py)."""
    _, tc = cfgs((8, 8, 12), nt=50, dt=1e-3, nu=0.1, transform="fft")
    z = 2.0 * np.pi * np.arange(12) / 12
    u0 = np.zeros((3, 8, 8, 12))
    u0[0] = np.sin(z)[None, None, :]
    fin = t3.rollout_final(tc, t3.init_from_velocity(tc, u0, "cpu"))
    close(t3.fields_from_hat(tc, fin[0]), u0 * np.exp(-0.1 * 50 * 1e-3),
          1e-12)


# --- the host-side constants, cached per (config with nt = 0, device) --------

PUBLIC = {"make_ops": t3.make_ops, "dft_tables": t3._dft_tables,
          "hermitian_weights": t3._hermitian_weights}


def _clear_constants():
    for f in t3._CONSTANT_CACHES.values():
        f.cache_clear()
    t3._fused_lamb_op.cache_clear()


def _fresh(name, cfg, device="cpu"):
    """The builder's result made anew, past its cache."""
    return t3._CONSTANT_CACHES[name].__wrapped__(
        dataclasses.replace(cfg, nt=0), torch.device(device))


def _same(got, want):
    """Bitwise equal tensors, or dicts of them with the same keys."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
        return
    assert got.dtype == want.dtype and got.device == want.device
    assert torch.equal(got, want)


def _cfg16(**kw):
    return t3.Spectral3DConfig(**dict(dict(nt=3, nx=16, ny=16, nz=16), **kw))


@pytest.mark.parametrize("forcing", ["none", "kolmogorov"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("engine", ["fft", "matmul"])
def test_cached_constants_are_bitwise_a_fresh_build(engine, dtype, forcing):
    cfg = _cfg16(transform=engine, dtype=dtype, forcing=forcing,
                 forcing_k=2)
    _clear_constants()
    names = ["make_ops", "hermitian_weights"] + (
        ["dft_tables"] if engine == "matmul" else [])
    for name in names:
        public = PUBLIC[name]
        first = public(cfg, "cpu")
        _same(first, _fresh(name, cfg))
        _same(public(cfg, "cpu"), first)  # the hit
        assert t3.constants_cache_info()[name].hits == 1


def test_configs_differing_only_in_nt_share_one_entry():
    """nt is dropped from the key, and None, "cpu" and torch.device("cpu")
    name one device; another nu or dt is its own entry with its own visc.
    Each caller gets its own dict over the shared tensors."""
    cfg = _cfg16(transform="matmul")
    _clear_constants()
    ops = t3.make_ops(cfg, "cpu")
    for other in (dataclasses.replace(cfg, nt=7),
                  dataclasses.replace(cfg, nt=1)):
        for dev in (None, "cpu", torch.device("cpu")):
            again = t3.make_ops(other, dev)
            assert again is not ops
            assert all(again[k] is ops[k] for k in ops)
    info = t3.constants_cache_info()["make_ops"]
    assert (info.misses, info.hits, info.currsize) == (1, 6, 1)
    ops["extra"] = ops["k2"]
    assert "extra" not in t3.make_ops(cfg, "cpu")
    for other in (dataclasses.replace(cfg, nu=2 * cfg.nu),
                  dataclasses.replace(cfg, dt=2 * cfg.dt)):
        own = t3.make_ops(other, "cpu")
        _same(own, _fresh("make_ops", other))
        assert not torch.equal(own["visc"], ops["visc"])
    assert t3.constants_cache_info()["make_ops"].misses == 3


JOB_ROUTES = [dict(transform="fft"),
              dict(transform="matmul", matmul_precision="high"),
              dict(transform="matmul", matmul_precision="default",
                   use_pallas_transform=True)]


def _job(cfg, step, u0):
    """The benchmark's 3D job: init, nt steps, the three diagnostics."""
    carry0 = t3.init_from_velocity(cfg, u0, "cpu")
    carry = carry0
    for _ in range(cfg.nt):
        carry, _ = step(carry)
    u_hat = carry[0]
    return [*carry0, *carry, t3.energy(cfg, u_hat), t3.enstrophy(cfg, u_hat),
            t3.divergence_max(cfg, u_hat)]


@pytest.mark.parametrize("route", JOB_ROUTES, ids=["fft", "matmul", "fused"])
def test_a_job_writes_into_no_cached_constant(route):
    cfg = _cfg16(**route)
    _clear_constants()
    step, _ = t3.make_step(cfg, "cpu")
    _job(cfg, step, t3.random_solenoidal_velocity(cfg, seed=5))
    names = ["make_ops", "hermitian_weights"] + (
        ["dft_tables"] if cfg.compact else [])
    for name in names:
        _same(PUBLIC[name](cfg, "cpu"), _fresh(name, cfg))


def test_constants_first_built_in_inference_mode_serve_autograd():
    """Built by a call under torch.inference_mode, the cached tensors are
    still saved for a later backward (ops/cache.py::device_table)."""
    cfg = _cfg16(transform="matmul", dtype="float64")
    _clear_constants()
    u0 = t3.random_solenoidal_velocity(cfg, seed=6)
    with torch.inference_mode():
        u_hat = t3.init_from_velocity(cfg, u0, "cpu")[0]
        t3.enstrophy(cfg, u_hat)
        t3.divergence_max(cfg, u_hat)
    u_hat = u_hat.clone().requires_grad_(True)
    (t3.enstrophy(cfg, u_hat) + t3.divergence_max(cfg, u_hat)).backward()
    assert torch.isfinite(torch.view_as_real(u_hat.grad)).all()
    assert t3.constants_cache_info()["make_ops"].hits >= 2


@pytest.mark.parametrize("route", JOB_ROUTES, ids=["fft", "matmul", "fused"])
def test_two_jobs_match_jobs_with_the_caches_cleared(route):
    cfg = _cfg16(**route)
    inputs = [t3.random_solenoidal_velocity(cfg, seed=s) for s in (7, 8)]
    _clear_constants()
    step, _ = t3.make_step(cfg, "cpu")
    warm = [_job(cfg, step, u0) for u0 in inputs]
    for u0, want in zip(inputs, warm):
        _clear_constants()
        cold_step, _ = t3.make_step(cfg, "cpu")
        for g, w in zip(_job(cfg, cold_step, u0), want):
            _same(g, w)
