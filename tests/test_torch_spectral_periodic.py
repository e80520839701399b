"""The port's 2D periodic spectral solver (ns_tpu_torch.solvers.
spectral_periodic) against ns_tpu's, in float64 on the CPU, on the same
numpy inputs, and the JAX tests' physics invariants run against the port.

Tolerances, relative to each output's scale: transforms <= 1e-12 (the same
DFT sums taken in another order), rollouts and diagnostics <= 1e-10 (after
a few steps the two differ at ~1e-15), a JAX carry continued in the port
<= 1e-12. The initial conditions are the same numpy code and are compared
bitwise. 'default' (bf16 inputs, fp32 sums) is held against a float64
emulation of the TPU's DEFAULT rounding points, not against JAX's CPU
'default', which is fp32.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.solvers import spectral_periodic as js
from ns_tpu_torch.solvers import spectral_periodic as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every engine: fft, padded matmul with and without dealiasing, compact
# matmul, real_gemm
ENGINES = {
    "fft": dict(transform="fft"),
    "matmul": dict(transform="matmul", matmul_precision="highest"),
    "matmul_nodealias": dict(transform="matmul", matmul_precision="highest",
                             dealias=False),
    "compact": dict(transform="matmul", matmul_precision="highest",
                    compact_spectrum=True),
    "real_gemm": dict(transform="matmul", matmul_precision="highest",
                      compact_spectrum=True, real_gemm=True),
}

def cfgs(shape=(24, 18), **kw):
    kw = dict(nx=shape[0], ny=shape[1], dtype="float64", **kw)
    return js.SpectralPeriodicConfig(**kw), ts.SpectralPeriodicConfig(**kw)


def npy(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, rel=1e-10):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_initial_conditions_bitwise():
    for dtype in ("float64", "float32"):
        kw = dict(nx=24, ny=18, dtype=dtype)
        jc = js.SpectralPeriodicConfig(**kw)
        tc = ts.SpectralPeriodicConfig(**kw)
        for k in (1, 2):
            got = ts.taylor_green_vorticity(tc, k=k)
            assert got.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(
                got, np.asarray(js.taylor_green_vorticity(jc, k)))
        for seed, k_peak in ((0, 10.0), (3, 4.0), (7, 30.0)):
            np.testing.assert_array_equal(
                ts.decaying_turbulence_vorticity(tc, seed=seed,
                                                 k_peak=k_peak),
                np.asarray(js.decaying_turbulence_vorticity(
                    jc, seed=seed, k_peak=k_peak)))
    jc, tc = cfgs(forcing="fno", forcing_k=3)
    np.testing.assert_array_equal(ts.forcing_vorticity_np(tc),
                                  js.forcing_vorticity_np(jc))
    np.testing.assert_array_equal(ts.hermitian_weights(17),
                                  js.hermitian_weights(17))


def test_config_validation_matches_jax():
    """The same errors, raised at the same points, in both packages."""
    bad = [dict(forcing="sinusoid"), dict(forcing="kolmogorov", forcing_k=0),
           dict(transform="dft")]
    for kw in bad:
        with pytest.raises(ValueError) as ej:
            js.SpectralPeriodicConfig(**kw)
        with pytest.raises(ValueError) as et:
            ts.SpectralPeriodicConfig(**kw)
        assert str(et.value) == str(ej.value)
    ts.SpectralPeriodicConfig(forcing="none", forcing_k=0)
    for kw, maker in ((dict(compact_spectrum=True), "make_step"),
                      (dict(transform="matmul", dealias=False,
                            compact_spectrum=True), "make_step"),
                      (dict(real_gemm=True, transform="matmul"), "make_step"),
                      (dict(transform="fft"), "make_step_compact")):
        jc, tc = cfgs((16, 16), **kw)
        with pytest.raises(ValueError) as ej:
            getattr(js, maker)(jc)
        with pytest.raises(ValueError) as et:
            getattr(ts, maker)(tc)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", list(ENGINES))
def test_transforms_match_jax(name):
    """fwd/inv of each engine, one field and a batch of three, <= 1e-12;
    the batched transform equals the per-field one."""
    jc, tc = cfgs(**ENGINES[name])
    if name == "fft":
        jt, tt = js.make_transforms(jc), ts.make_transforms(tc)
    elif name == "real_gemm":
        jt, tt = js.make_real_gemm_transforms(jc), \
            ts.make_real_gemm_transforms(tc)
    elif name == "compact":
        jt, tt = js.make_compact_transforms(jc), \
            ts.make_compact_transforms(tc)
    else:
        jt, tt = js.make_transforms(jc), ts.make_transforms(tc)
    w = np.random.default_rng(1).normal(size=(3, 24, 18))
    z_j = jax.jit(jt[0])(jnp.asarray(w))
    z_t = tt[0](torch.as_tensor(w))
    close(z_t, z_j, 1e-12)
    close(tt[0](torch.as_tensor(w[1])), z_t[1], 1e-12)
    back_j = jax.jit(jt[1])(z_j)
    back_t = tt[1](torch.as_tensor(np.array(z_j)))
    close(back_t, back_j, 1e-12)
    close(tt[1](torch.as_tensor(np.array(z_j)[2])), back_t[2], 1e-12)


def test_compact_layout_helpers_match_jax():
    jc, tc = cfgs()
    rows_j = js._compact_meta(jc)
    rows_t = ts._compact_meta(tc)
    np.testing.assert_array_equal(rows_t[0], rows_j[0])
    assert rows_t[1:] == rows_j[1:]
    rng = np.random.default_rng(2)
    z = rng.normal(size=(2, 15, 6)) + 1j * rng.normal(size=(2, 15, 6))
    full_j = js.expand_compact(jc, jnp.asarray(z))
    full_t = ts.expand_compact(tc, torch.as_tensor(z))
    np.testing.assert_array_equal(npy(full_t), np.asarray(full_j))
    np.testing.assert_array_equal(npy(ts.gather_compact(tc, full_t)), z)
    z2 = rng.normal(size=(2, 15, 6))
    np.testing.assert_array_equal(
        npy(ts.compact_real_to_complex(torch.as_tensor(z2))),
        np.asarray(js.compact_real_to_complex(jnp.asarray(z2))))


ROLLOUTS = [(name, forcing) for name in ENGINES
            for forcing in ("none", "kolmogorov", "fno")
            if forcing == "none" or name in ("fft", "compact", "real_gemm")]


@pytest.mark.parametrize("name,forcing", ROLLOUTS)
def test_rollouts_match_jax(name, forcing):
    """rollout_final and simulate_hat, 5 steps of decaying turbulence,
    forced and unforced, engine for engine, <= 1e-10."""
    jc, tc = cfgs(nt=5, dt=2e-3, nu=1e-2, forcing=forcing, forcing_k=2,
                  **ENGINES[name])
    w0 = ts.decaying_turbulence_vorticity(tc, seed=3, k_peak=4.0)
    c_j = js.init_from_vorticity(jc, w0)
    c_t = ts.init_from_vorticity(tc, w0, "cpu")
    for g, w in zip(ts.carry_to_numpy(c_t), ts.carry_to_numpy(c_j)):
        close(g, w)
    fin_j = jax.jit(lambda c: js.rollout_final(jc, c))(c_j)
    fin_t = ts.rollout_final(tc, c_t)
    for g, w in zip(ts.carry_to_numpy(fin_t), ts.carry_to_numpy(fin_j)):
        close(g, w)
    hats_j = jax.jit(lambda c: js.simulate_hat(jc, c))(c_j)
    hats_t = ts.simulate_hat(tc, c_t)
    assert hats_t.shape == (5,) + tuple(c_t[0].shape)
    close(hats_t, hats_j)
    close(ts.physical_from_carry(tc, fin_t[0]),
          js.physical_from_carry(jc, fin_j[0]))


def test_bench_rollout_final_compact_matches_jax():
    """bench.py's rollout (rollout_final_compact from
    init_from_vorticity_compact) and the real_gemm carry builder."""
    jc, tc = cfgs((32, 32), nt=4, dt=5e-4, nu=1e-4, transform="matmul",
                  matmul_precision="highest")
    w0 = ts.decaying_turbulence_vorticity(tc, seed=0, k_peak=30.0)
    c_j = js.init_from_vorticity_compact(jc, w0)
    c_t = ts.init_from_vorticity_compact(tc, w0, "cpu")
    fin_j = jax.jit(lambda c: js.rollout_final_compact(jc, c))(c_j)
    for g, w in zip(ts.carry_to_numpy(ts.rollout_final_compact(tc, c_t)),
                    ts.carry_to_numpy(fin_j)):
        close(g, w)
    for g, w in zip(ts.carry_to_numpy(ts.init_from_vorticity_real(
            tc, w0, "cpu")), ts.carry_to_numpy(
            js.init_from_vorticity_real(jc, w0))):
        close(g, w)


@pytest.mark.parametrize("name", ["fft", "compact", "real_gemm"])
def test_simulate_strided_matches_jax(name):
    """simulate_strided's (u, v, p) against the JAX one, and its frame
    semantics: frame i is the state after 1 + spinup + i*stride steps."""
    jc, tc = cfgs(nt=3, dt=2e-3, nu=1e-2, forcing="kolmogorov", forcing_k=2,
                  **ENGINES[name])
    w0 = ts.decaying_turbulence_vorticity(tc, seed=5, k_peak=4.0)
    want = jax.jit(lambda w: js.simulate_strided(jc, w, 3, stride=2,
                                                 spinup=1))(jnp.asarray(w0))
    got = ts.simulate_strided(tc, w0, 3, stride=2, spinup=1, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (3, 24, 18)
        close(g, w)
    carry = ts.init_from_vorticity(tc, w0, "cpu")
    step, _ = ts.make_step(tc)
    for _ in range(6):
        carry, _ = step(carry)
    full = ts._to_full(tc, carry[0])
    close(got[0][2], ts.fields_from_hat(tc, full)[0], 1e-13)
    close(got[2][2], ts.pressure_from_hat(tc, full), 1e-13)


def test_diagnostics_match_jax():
    """fields_from_hat, pressure_from_hat, energy_spectrum and
    divergence_max of a 5-step state, batched too, <= 1e-10."""
    jc, tc = cfgs(nt=5, dt=2e-3, nu=1e-2)
    w0 = ts.decaying_turbulence_vorticity(tc, seed=1, k_peak=4.0)
    fin_j = js.rollout_final(jc, js.init_from_vorticity(jc, w0))[0]
    fin_t = ts.rollout_final(tc, ts.init_from_vorticity(tc, w0, "cpu"))[0]
    for g, w in zip(ts.fields_from_hat(tc, fin_t),
                    js.fields_from_hat(jc, fin_j)):
        close(g, w)
    close(ts.pressure_from_hat(tc, fin_t), js.pressure_from_hat(jc, fin_j))
    pair = torch.stack([fin_t, 2 * fin_t])
    close(ts.pressure_from_hat(tc, pair)[1],
          js.pressure_from_hat(jc, 2 * fin_j))
    k_t, e_t = ts.energy_spectrum(tc, fin_t)
    k_j, e_j = js.energy_spectrum(jc, fin_j)
    np.testing.assert_array_equal(npy(k_t), np.asarray(k_j))
    close(e_t, e_j)
    div_t = float(ts.divergence_max(tc, fin_t))
    assert div_t < 1e-12 and float(js.divergence_max(jc, fin_j)) < 1e-12


@pytest.mark.parametrize("name", ["fft", "compact", "real_gemm"])
def test_jax_carry_continues_in_the_port(name):
    """A JAX carry brought over with carry_from_numpy steps alike."""
    jc, tc = cfgs(dt=2e-3, nu=1e-2, **ENGINES[name])
    w0 = ts.decaying_turbulence_vorticity(tc, seed=2, k_peak=4.0)
    step_j, _ = js.make_step(jc)
    adv = jax.jit(lambda c: step_j(c)[0])
    c1 = adv(js.init_from_vorticity(jc, w0))
    want = ts.carry_to_numpy(adv(c1))
    carried = ts.carry_from_numpy(tc, ts.carry_to_numpy(c1), device="cpu")
    assert carried[0].dtype == (torch.float64 if name == "real_gemm"
                                else torch.complex128)
    step_t, _ = ts.make_step(tc)
    for g, w in zip(ts.carry_to_numpy(step_t(carried)[0]), want):
        close(g, w, 1e-12)


def test_system_matches_jax_system():
    """NavierStokesSystem: simulate, simulate_from, simulate_strided(w_ic=),
    simulate_vorticity and final_state, compact engine, forced."""
    kw = dict(nt=4, nx=16, ny=16, dt=2e-3, nu=1e-2, dtype="float64",
              transform="matmul", matmul_precision="highest",
              compact_spectrum=True, forcing="fno", forcing_k=2)
    tc = ts.SpectralPeriodicConfig(**kw)
    w0 = ts.decaying_turbulence_vorticity(tc, seed=0, k_peak=4.0)
    w1 = ts.decaying_turbulence_vorticity(tc, seed=1, k_peak=4.0)
    sys_t = ts.NavierStokesSystem(w0, device="cpu", **kw)
    sys_j = js.NavierStokesSystem(w0, **kw)
    for g, w in zip(sys_t.simulate(), sys_j.simulate()):
        assert g.shape == (4, 16, 16)
        close(g, w)
    for g, w in zip(sys_t.simulate_from(w1), sys_j.simulate_from(w1)):
        close(g, w)
    for g, w in zip(sys_t.simulate_strided(2, stride=2, spinup=1, w_ic=w1),
                    sys_j.simulate_strided(2, stride=2, spinup=1, w_ic=w1)):
        close(g, w)
    close(sys_t.simulate_vorticity(), sys_j.simulate_vorticity())
    for g, w in zip(ts.carry_to_numpy(sys_t.final_state()),
                    ts.carry_to_numpy(sys_j.final_state())):
        close(g, w)


def test_auto_engine_matches_jax_policy():
    """transform='auto' resolves at construction to the engine the JAX
    package picks (matmul + compact under the crossover when dealiased,
    fft otherwise), except where ROADMAP.md §3 records the card's rule:
    fft at every size and precision, where the JAX package keeps matmul
    + compact up to 8192^2."""
    for n in (16, 48, 64, 256, 1024, 2048, 4096, 8192):
        for dealias in (True, False):
            for prec in ("default", "high", "highest"):
                kw = dict(nx=n, ny=n, dealias=dealias, transform="auto",
                          matmul_precision=prec)
                jc = js.SpectralPeriodicConfig(**kw)
                tc = ts.SpectralPeriodicConfig(**kw)
                got = (tc.transform, tc.compact_spectrum)
                if dealias and n < 8192:  # the recorded difference
                    assert (jc.transform, jc.compact_spectrum) == (
                        "matmul", True)
                    assert got == ("fft", False), kw
                else:
                    assert got == (jc.transform, jc.compact_spectrum), kw
    rect = ts.SpectralPeriodicConfig(nx=32, ny=96, transform="auto")
    assert (rect.transform, rect.compact_spectrum) == ("fft", False)


# --- the JAX tests' physics invariants, against the port ---------------------

def test_taylor_green_analytic_decay():
    tc = ts.SpectralPeriodicConfig(nt=100, nx=64, ny=64, dt=0.01, nu=0.01,
                                   dtype="float64")
    w0 = ts.taylor_green_vorticity(tc, k=1)
    w_hat, _ = ts.rollout_final(tc, ts.init_from_vorticity(tc, w0, "cpu"))
    w_final = torch.fft.irfft2(w_hat, s=(64, 64)).numpy()
    np.testing.assert_allclose(w_final, w0 * np.exp(-2.0 * 0.01 * 1.0),
                               rtol=0, atol=1e-10)


def test_divergence_free_and_energy_monotone():
    tc = ts.SpectralPeriodicConfig(nt=50, nx=64, ny=64, dt=0.002, nu=5e-3,
                                   dtype="float64")
    w0 = ts.decaying_turbulence_vorticity(tc, seed=0)
    w_hats = ts.simulate_hat(tc, ts.init_from_vorticity(tc, w0, "cpu"))
    assert float(ts.divergence_max(tc, w_hats[-1])) < 1e-12
    energy = lambda h: float(ts.energy_spectrum(tc, h)[1].sum())
    e = [energy(w_hats[i]) for i in (0, 25, 49)]
    assert np.isfinite(e).all() and e[0] > e[1] > e[2]


def test_pressure_taylor_green():
    """p = rho/4 (cos 2x + cos 2y) up to the gauge mean."""
    tc = ts.SpectralPeriodicConfig(nx=64, ny=64, dtype="float64")
    w_hat = torch.fft.rfft2(torch.as_tensor(ts.taylor_green_vorticity(tc)))
    p = ts.pressure_from_hat(tc, w_hat).numpy()
    x = np.arange(64) * 2 * np.pi / 64
    X, Y = np.meshgrid(x, x, indexing="ij")
    p_exact = 0.25 * (np.cos(2 * X) + np.cos(2 * Y))
    np.testing.assert_allclose(p - p.mean(), p_exact - p_exact.mean(),
                               atol=1e-10)


def test_compact_and_real_gemm_match_padded_rollouts():
    """The compact carry expanded equals the padded matmul rollout, and
    real_gemm equals the complex compact engine (<= 1e-12)."""
    kw = dict(nt=6, nx=32, ny=32, dt=2e-3, nu=1e-3, dtype="float64",
              transform="matmul", matmul_precision="highest")
    pad = ts.SpectralPeriodicConfig(**kw)
    comp = ts.SpectralPeriodicConfig(compact_spectrum=True, **kw)
    real = ts.SpectralPeriodicConfig(compact_spectrum=True, real_gemm=True,
                                     **kw)
    w0 = ts.decaying_turbulence_vorticity(pad, seed=5)
    zp = ts.rollout_final(pad, ts.init_from_vorticity(pad, w0, "cpu"))[0]
    zc = ts.rollout_final(comp, ts.init_from_vorticity(comp, w0, "cpu"))[0]
    zr = ts.rollout_final(real, ts.init_from_vorticity(real, w0, "cpu"))[0]
    close(ts.expand_compact(comp, zc), zp, 1e-12)
    close(ts.compact_real_to_complex(zr), zc, 1e-12)


def test_kolmogorov_laminar_fixed_point():
    nu, k, amp = 0.1, 2, 0.1
    for engine in ("fft", "compact"):
        tc = ts.SpectralPeriodicConfig(nt=200, nx=32, ny=32, dt=1e-3, nu=nu,
                                       dtype="float64", forcing="kolmogorov",
                                       forcing_k=k, forcing_amp=amp,
                                       **ENGINES[engine])
        w_s = ts.forcing_vorticity_np(tc) / (nu * k * k)
        w_hat, _ = ts.rollout_final(tc, ts.init_from_vorticity(tc, w_s,
                                                                "cpu"))
        np.testing.assert_allclose(npy(ts.physical_from_carry(tc, w_hat)),
                                   w_s, rtol=0, atol=1e-8)


# --- 'default' on the CPU: the TPU's DEFAULT rounding points -----------------

def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16) \
        .double().numpy()


def test_default_compact_transforms_are_the_tpu_default():
    """At 'default' each GEMM stage takes bf16-rounded inputs (the tables
    rounded once when built) and sums in fp32: within 1e-3 of max|out| of
    a float64 emulation that rounds the same stage inputs (the fp32 sums
    land an intermediate on the other bf16 neighbour now and then, as in
    the 3D transforms' 'default' bound), and far from the unrounded
    float64 transform (~4e-3 of max|out| for bf16's 8 bits)."""
    kw = dict(nx=48, ny=40, transform="matmul", compact_spectrum=True)
    tc = ts.SpectralPeriodicConfig(matmul_precision="default", **kw)
    hi = ts.SpectralPeriodicConfig(dtype="float64", **kw)
    fwd, inv = ts.make_compact_transforms(tc)
    fwd64, inv64 = ts.make_compact_transforms(hi)
    w = ts.decaying_turbulence_vorticity(hi, seed=4, k_peak=6.0)
    rows, _, _, kyc = ts._compact_meta(hi)
    M = ts._complex_dft(tc)
    Fx, Fxi = M["Fx"][rows, :], M["Fx_inv"][:, rows]
    FyT, B = M["Fy"][:kyc, :].T, M["B"][:kyc, :]
    r = lambda z: _bf16(z.real) + 1j * _bf16(z.imag)
    t = _bf16(w) @ r(FyT)
    want = r(Fx) @ r(t.astype(np.complex64))
    z = fwd(torch.as_tensor(w, dtype=torch.float32))
    assert z.dtype == torch.complex64
    err = np.abs(npy(z) - want).max() / np.abs(want).max()
    assert err <= 1e-3
    assert np.abs(npy(fwd64(torch.as_tensor(w))) - want).max() \
        / np.abs(want).max() > 1e-4
    zt = torch.as_tensor(want.astype(np.complex64))
    a = r(Fxi) @ r(want.astype(np.complex64))
    want_w = (_bf16(a.real.astype(np.float32)) @ _bf16(B.real)
              - _bf16(a.imag.astype(np.float32)) @ _bf16(B.imag))
    got_w = npy(inv(zt))
    assert got_w.dtype == np.float32
    assert np.abs(got_w - want_w).max() / np.abs(want_w).max() <= 1e-3


def test_default_tables_are_rounded_once():
    """At 'default' the float32 engines keep bf16 tables (the bits the
    GEMM layer would round them to); other precisions and float64 keep
    their own dtype."""
    for prec, dtype, want in (("default", "float32", torch.bfloat16),
                              ("high", "float32", torch.float32),
                              ("default", "float64", torch.float64)):
        tc = ts.SpectralPeriodicConfig(nx=16, ny=16, dtype=dtype,
                                       matmul_precision=prec)
        t = ts._table(tc, np.array([[1.0 + 2**-12]]), None)
        assert t.dtype == want


def test_default_rollout_stays_near_float64():
    """20 steps of compact 'default' (CPU emulation of bf16 inputs) stay
    within 2e-2 of max|w| of the float64 rollout; 'high' within 1e-5."""
    kw = dict(nt=20, nx=32, ny=32, dt=2e-3, nu=1e-3, transform="matmul",
              compact_spectrum=True)
    ref = ts.SpectralPeriodicConfig(dtype="float64", **kw)
    w0 = ts.decaying_turbulence_vorticity(ref, seed=2, k_peak=4.0)
    want = npy(ts.physical_from_carry(ref, ts.rollout_final(
        ref, ts.init_from_vorticity(ref, w0, "cpu"))[0]))
    for prec, bound in (("default", 2e-2), ("high", 1e-5)):
        tc = ts.SpectralPeriodicConfig(matmul_precision=prec, **kw)
        fin = ts.rollout_final(tc, ts.init_from_vorticity(tc, w0, "cpu"))
        got = npy(ts.physical_from_carry(tc, fin[0]))
        assert np.abs(got - want).max() / np.abs(want).max() <= bound, prec


# --- the port stands alone --------------------------------------------------

_NO_JAX = """
import json, sys
from ns_tpu_torch.solvers import diffable, spectral_periodic as sp
cfg = sp.SpectralPeriodicConfig(nt=2, nx=16, ny=16, transform="auto")
sys_ = sp.NavierStokesSystem(sp.taylor_green_vorticity(cfg), nt=2, nx=16,
                             ny=16, transform="auto", device="cpu")
u, v, p = sys_.simulate()
print(json.dumps({"jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "ns_tpu")),
                  "shape": list(u.shape)}))
"""


def test_port_modules_import_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _NO_JAX],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"jax": [], "shape": [2, 16, 16]}


def test_system_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ts.SpectralPeriodicConfig(nx=8, ny=8)
    w0 = ts.taylor_green_vorticity(cfg)
    for build in (lambda d: ts.NavierStokesSystem(w0, nt=1, nx=8, ny=8,
                                                  device=d),
                  lambda d: ts.init_from_vorticity(cfg, w0, d),
                  lambda d: ts.simulate_strided(cfg, w0, 1, device=d)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(None)
        build("cpu")
    host = ts.carry_to_numpy(ts.init_from_vorticity(cfg, w0, "cpu"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ts.carry_from_numpy(cfg, host)
    assert ts.carry_from_numpy(cfg, host, "cpu")[0].device.type == "cpu"
    carry = ts.init_from_vorticity(cfg, torch.as_tensor(w0))
    assert carry[0].device.type == "cpu"
