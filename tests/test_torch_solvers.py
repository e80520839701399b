"""Port solvers (ns_tpu_torch.solvers) against the goldens and the JAX
package's solvers, all in float64 on the CPU.

Tolerances: direct_fd vs its golden <= 1e-12 (same arithmetic, Jacobi
sweeps); chorin_fd vs the JAX solver <= 1e-9 (same algorithm; the ADI
matmuls and reductions sum in another order); chorin_fd red-black vs the
Gauss-Seidel goldens at tests/test_chorin_fd.py's converged-gate bounds; one
step from a state carried across packages <= 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.solvers import chorin_fd as j_chorin
from ns_tpu.solvers import direct_fd as j_direct
from ns_tpu_torch.core import state as tstate
from ns_tpu_torch.ops import gemm
from ns_tpu_torch.ops import kernels
from ns_tpu_torch.ops.kernels import poisson_kernels
from ns_tpu_torch.solvers import chorin_fd, direct_fd
from tests.conftest import load_golden


def cavity_bcs(dx, dy):
    u_bc = [j_dirichlet(0, "left"), j_dirichlet(1, "right"),
            j_dirichlet(0, "top"), j_dirichlet(0, "bottom")]
    v_bc = [j_dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    p_bc = [j_dirichlet(0, "top"), j_neumann(0, "bottom", dx, dy),
            j_neumann(0, "left", dx, dy), j_neumann(0, "right", dx, dy)]
    return u_bc, v_bc, p_bc


def np_all(seqs):
    return [s.numpy() for s in seqs]


def test_direct_fd_matches_golden_nt20():
    nx = 50
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    z = np.zeros((nx, nx))
    sys_ = direct_fd.NavierStokesSystem(z, z, z, *bcs, nt=20, nit=50, nx=nx,
                                        ny=nx, dt=0.001, rho=1, nu=0.1,
                                        dtype=torch.float64, device="cpu")
    u, v, p = np_all(sys_.simulate())
    g = load_golden("direct_fd_nt20.npz")
    for got, key in ((u, "u"), (v, "v"), (p, "p")):
        np.testing.assert_allclose(got, g[key], rtol=0, atol=1e-12)


def test_direct_fd_full_horizon_golden_nt200():
    """The reference's full nt=200 horizon at the snapshot frames, at
    tests/test_direct_fd.py's bounds (1e-13 velocities, 1e-12 pressure)."""
    nx = 50
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    z = np.zeros((nx, nx))
    sys_ = direct_fd.NavierStokesSystem(z, z, z, *bcs, nt=200, nit=50,
                                        nx=nx, ny=nx, dt=0.001, rho=1, nu=0.1,
                                        dtype=torch.float64, device="cpu")
    u, v, p = np_all(sys_.simulate())
    g = load_golden("direct_fd_nt200_snapshots.npz")
    for i, f in enumerate(g["frames"]):
        np.testing.assert_allclose(u[f], g["u"][i], rtol=0, atol=1e-13)
        np.testing.assert_allclose(v[f], g["v"][i], rtol=0, atol=1e-13)
        np.testing.assert_allclose(p[f], g["p"][i], rtol=0, atol=1e-12)


def chorin_pair(method, nt=12, nx=51, pressure_mode="redblack", nit=200):
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    z = np.zeros((nx, nx))
    kw = dict(nt=nt, nit=nit, nx=nx, ny=nx, dt=0.001, rho=1, nu=0.1,
              beta=1.25, method=method, pressure_mode=pressure_mode)
    j = j_chorin.NavierStokesSystem(z, z, z, *bcs, dtype=jnp.float64, **kw)
    t = chorin_fd.NavierStokesSystem(z, z, z, *bcs, dtype=torch.float64,
                                     device="cpu", **kw)
    return [np.asarray(a) for a in j.simulate()], np_all(t.simulate())


@pytest.mark.parametrize("method", ["semi_implicit", "explicit"])
def test_chorin_fd_matches_jax_solver(method):
    """Red-black pressure, nt=12, 51^2: the port vs the JAX solver,
    <= 1e-9; and both against the Gauss-Seidel golden at the converged-gate
    bounds of tests/test_chorin_fd.py (u, v 1e-3; p 0.2)."""
    want, got = chorin_pair(method)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    gold = load_golden(f"chorin_fd_{method}_nt12.npz")
    for g, key, atol in zip(got, "uvp", (1e-3, 1e-3, 0.2)):
        np.testing.assert_allclose(g, gold[key], rtol=0, atol=atol)


def test_chorin_fd_cg_mode_matches_jax_solver():
    """CG pressure (plain torch on every device), nt=4, 24^2: <= 1e-9."""
    want, got = chorin_pair("semi_implicit", nt=4, nx=24, pressure_mode="cg",
                            nit=60)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


def test_chorin_fd_gauss_seidel_mode_matches_jax_solver():
    """Wavefront Gauss-Seidel pressure, nt=2 on 16^2 (eager wavefront
    sweeps are slow on the CPU): <= 1e-12."""
    want, got = chorin_pair("explicit", nt=2, nx=16,
                            pressure_mode="gauss_seidel", nit=40)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("family", ["direct_fd", "chorin_semi_implicit",
                                    "chorin_explicit"])
def test_state_carried_across_packages_steps_alike(family):
    """A JAX FlowState read back as numpy (state_to_numpy) goes into the
    port (state_from_numpy); one step in each package agrees <= 1e-12."""
    nx = 32
    dx = dy = 2.0 / (nx - 1)
    bcs = cavity_bcs(dx, dy)
    rng = np.random.default_rng(11)
    u, v, p = (0.1 * rng.normal(size=(nx, nx)) for _ in range(3))
    if family == "direct_fd":
        j_sys = j_direct.NavierStokesSystem(u, v, p, *bcs, nt=1, nit=20,
                                            nx=nx, ny=nx, dtype=jnp.float64)
        t_sys = direct_fd.NavierStokesSystem(u, v, p, *bcs, nt=1, nit=20,
                                             nx=nx, ny=nx,
                                             dtype=torch.float64,
                                             device="cpu")
    else:
        kw = dict(nt=1, nit=50, nx=nx, ny=nx, nu=0.1,
                  method=family.split("_", 1)[1])
        j_sys = j_chorin.NavierStokesSystem(u, v, p, *bcs,
                                            dtype=jnp.float64, **kw)
        t_sys = chorin_fd.NavierStokesSystem(u, v, p, *bcs,
                                             dtype=torch.float64,
                                             device="cpu", **kw)
    j_state = j_sys.step(j_sys.state0)
    carried = tstate.state_from_numpy(tstate.state_to_numpy(j_state),
                                      device="cpu", dtype=torch.float64)
    assert (carried.u_prev is None) == (family == "direct_fd")
    want = tstate.state_to_numpy(j_sys.step(j_state))
    got = tstate.state_to_numpy(t_sys.step(carried))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


def test_large_grid_routes_to_multiblock_sor(monkeypatch):
    """A grid past one block's shared memory takes K5's route (its twin
    sor_redblack_tiled on the CPU), gated every k=8 sweeps."""
    nx = 20
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    rng = np.random.default_rng(5)
    u, v, p = (0.1 * rng.normal(size=(nx, nx)) for _ in range(3))
    sys_ = chorin_fd.NavierStokesSystem(u, v, p, *bcs, nt=1, nit=30, nx=nx,
                                        ny=nx, nu=0.1, method="explicit",
                                        dtype=torch.float64, device="cpu")
    small = sys_.step(sys_.state0)
    monkeypatch.setattr(poisson_kernels, "SMEM_BUDGET", 0)
    calls = []
    real = kernels.sor_redblack_tiled
    monkeypatch.setattr(poisson_kernels, "sor_redblack_tiled",
                        lambda *a: calls.append(a[7]) or real(*a))
    large = sys_.step(sys_.state0)
    assert calls == [8]  # one solve, gated every k=8 sweeps
    assert not torch.equal(small.p, large.p)  # ran whole groups of 8


def direct_pair(nx, nt, nit=50):
    """The port's and the JAX direct_fd rollouts on one random state."""
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    rng = np.random.default_rng(7)
    u, v, p = (0.1 * rng.normal(size=(nx, nx)) for _ in range(3))
    kw = dict(nt=nt, nit=nit, nx=nx, ny=nx, dt=1e-4, rho=1, nu=0.1)
    j = j_direct.NavierStokesSystem(u, v, p, *bcs, dtype=jnp.float64, **kw)
    t = direct_fd.NavierStokesSystem(u, v, p, *bcs, dtype=torch.float64,
                                     device="cpu", **kw)
    return j, t


def test_direct_fd_beyond_one_block_matches_jax():
    """130^2 float64 (two grids need 270 KB, past one block's shared
    memory): 5 steps of the port equal ns_tpu's direct_fd <= 1e-12."""
    j, t = direct_pair(130, 5)
    for got, want in zip(np_all(t.simulate()), j.simulate()):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


def test_large_grid_routes_to_multiblock_jacobi(monkeypatch):
    """pressure_poisson takes K2's multi-block form where the ping-pong
    pair does not fit one block (130^2 float64), and the one-block form
    where it does (50^2); both take the same twin on the CPU."""
    calls = []
    for name in ("jacobi_fused", "jacobi_multiblock"):
        real = getattr(direct_fd, name)
        monkeypatch.setattr(direct_fd, name,
                            lambda *a, _n=name, _f=real:
                            calls.append((_n, a[0].shape[0])) or _f(*a))
    for nx in (50, 130):
        _, t = direct_pair(nx, 1, nit=3)
        t.step(t.state0)
    assert calls == [("jacobi_fused", 50), ("jacobi_multiblock", 130)]
    assert not poisson_kernels.smem_fits(130, 130, 2, 8)
    assert poisson_kernels.smem_fits(130, 130, 2, 4)


def test_config_validation_and_not_yet_ported_modes():
    """Bad settings raise; the modes that once waited for the port of
    fast_poisson and multigrid are accepted, as ns_tpu accepts them."""
    with pytest.raises(ValueError):
        chorin_fd.ChorinFDConfig(method="bogus")
    with pytest.raises(ValueError):
        chorin_fd.ChorinFDConfig(nx=10, ny=12)  # quirk ADI needs square
    for kw in (dict(method="helmholtz"), dict(pressure_mode="dst"),
               dict(pressure_mode="multigrid", mg_cycles=3)):
        cfg = chorin_fd.ChorinFDConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
    assert direct_fd.DirectFDConfig(pressure_mode="exact").pressure_mode \
        == "exact"
    with pytest.raises(ValueError):
        direct_fd.DirectFDConfig(pressure_mode="bogus")


def test_chorin_fd_systems_take_the_same_keywords():
    """Repair: the port's ChorinFDConfig and NavierStokesSystem lacked
    ns_tpu's `mg_cycles`. Both systems now build from one keyword set,
    mg_cycles included, with equal config fields and the JAX default 6."""
    nx = 17
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    z = np.zeros((nx, nx))
    kw = dict(nt=2, nit=30, nx=nx, ny=nx, dt=1e-3, rho=1, nu=0.1,
              beta=1.25, method="explicit", quirk_compat=True,
              pressure_mode="multigrid", mg_cycles=3, gemm_precision="high")
    j = j_chorin.NavierStokesSystem(z, z, z, *bcs, dtype=jnp.float64, **kw)
    t = chorin_fd.NavierStokesSystem(z, z, z, *bcs, dtype=torch.float64,
                                     device="cpu", **kw)
    for field in dataclasses.fields(t.cfg):
        assert getattr(t.cfg, field.name) == getattr(j.cfg, field.name)
    assert chorin_fd.ChorinFDConfig().mg_cycles == \
        j_chorin.ChorinFDConfig().mg_cycles == 6


@pytest.mark.parametrize("method,mode,nx,mg", [
    ("semi_implicit", "dst", 51, 6), ("explicit", "dst", 40, 6),
    ("explicit", "multigrid", 33, 2), ("semi_implicit", "multigrid", 30, 3),
    ("helmholtz", "redblack", 24, 6), ("helmholtz", "multigrid", 33, 6)])
def test_chorin_fd_new_modes_match_jax_solver(method, mode, nx, mg):
    """dst, multigrid (V-cycles at 33^2, MGCG at 30^2) and the helmholtz
    predictor, nt=5: the port vs ns_tpu <= 1e-9 (GEMMs and MGCG's inner
    products sum in another order)."""
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    z = np.zeros((nx, nx))
    kw = dict(nt=5, nit=100, nx=nx, ny=nx, dt=0.001, rho=1, nu=0.1,
              beta=1.25, method=method, pressure_mode=mode, mg_cycles=mg)
    j = j_chorin.NavierStokesSystem(z, z, z, *bcs, dtype=jnp.float64, **kw)
    t = chorin_fd.NavierStokesSystem(z, z, z, *bcs, dtype=torch.float64,
                                     device="cpu", **kw)
    for g, w in zip(np_all(t.simulate()), j.simulate()):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-9)


@pytest.mark.parametrize("nx", [50, 31])
def test_direct_fd_exact_mode_matches_jax(nx):
    """direct_fd pressure_mode='exact' (the mixed-BC eigenbasis solve), 5
    steps from a random state: the port vs ns_tpu <= 1e-9."""
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    rng = np.random.default_rng(3)
    u, v, p = (0.1 * rng.normal(size=(nx, nx)) for _ in range(3))
    kw = dict(nt=5, nit=50, nx=nx, ny=nx, dt=1e-4, rho=1, nu=0.1,
              pressure_mode="exact")
    j = j_direct.NavierStokesSystem(u, v, p, *bcs, dtype=jnp.float64, **kw)
    t = direct_fd.NavierStokesSystem(u, v, p, *bcs, dtype=torch.float64,
                                     device="cpu", **kw)
    for g, w in zip(np_all(t.simulate()), j.simulate()):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-9)


@pytest.mark.parametrize("nx,twin", [(128, "sor_redblack_packed_tiled"),
                                     (130, "sor_redblack_tiled")])
def test_large_grid_routes_by_the_packed_predicate(monkeypatch, nx, twin):
    """Beyond one block, nx % 128 == 0 and ny % 256 == 0 take K4 (its twin
    on the CPU), where ns_tpu ran its packed kernel; 130x256 takes K5."""
    ny = 256
    bcs = cavity_bcs(2.0 / (nx - 1), 2.0 / (ny - 1))
    rng = np.random.default_rng(9)
    u, v, p = (0.1 * rng.normal(size=(nx, ny)) for _ in range(3))
    sys_ = chorin_fd.NavierStokesSystem(u, v, p, *bcs, nt=1, nit=9, nx=nx,
                                        ny=ny, nu=0.1, method="explicit",
                                        dtype=torch.float64, device="cpu")
    calls = []
    for name in ("sor_redblack_packed_tiled", "sor_redblack_tiled"):
        real = getattr(poisson_kernels, name)
        monkeypatch.setattr(poisson_kernels, name,
                            lambda *a, _n=name, _f=real:
                            calls.append((_n, a[7])) or _f(*a))
    sys_.step(sys_.state0)
    assert calls == [(twin, 8)]


def bf16_emulation(a, b):
    """The TPU DEFAULT product: inputs rounded to bf16 (RNE), the product
    of the rounded values taken in float64."""
    r = lambda x: x.to(torch.bfloat16).to(torch.float64)
    if a.is_complex() or b.is_complex():
        c = lambda x: (torch.complex(r(x.real), r(x.imag)) if x.is_complex()
                       else r(x).to(torch.complex128))
        return c(a) @ c(b)
    return r(a) @ r(b)


def test_gemm_precision_maps_to_torch():
    """float32: None/'highest' are plain fp32 (equal to a @ b); 'default'
    rounds the inputs to bf16 and returns the fp32 product without
    rounding it: within 1e-5 of max|out| of the float64 product of the
    rounded inputs (an fp32 GEMM of them lands ~2e-7 away; rounding the
    output to bf16 as well, the fault repaired here, gave ~3e-3). float64
    ignores the setting. The complex form runs the same menu on the
    parts."""
    rng = np.random.default_rng(0)
    a, b = (torch.as_tensor(rng.normal(size=(40, 40)), dtype=torch.float32)
            for _ in range(2))
    exact = a @ b
    assert torch.equal(chorin_fd.matmul(a, b, None), exact)
    assert torch.equal(chorin_fd.matmul(a, b, "highest"), exact)
    bf = chorin_fd.matmul(a, b, "default")
    assert bf.dtype == torch.float32
    err = float((bf - exact).abs().max())
    assert 1e-4 < err < 0.5  # the input rounding shows against fp32
    want = bf16_emulation(a, b)
    scale = float(want.abs().max())
    assert float((bf.double() - want).abs().max()) <= 1e-5 * scale
    a64 = a.double()
    assert torch.equal(chorin_fd.matmul(a64, a64, "default"), a64 @ a64)
    c = torch.complex(a, b)
    want = (c.to(torch.complex128) @ a64.to(torch.complex128))
    for prec, tol in (("highest", 1e-4), ("default", 0.5)):
        got = gemm.cmatmul(c, a, prec).to(torch.complex128)
        err = float((got - want).abs().max())
        assert err < tol and (prec == "highest" or err > 1e-4)
    assert torch.equal(gemm.cmatmul(a, b, None), exact)


def test_gemm_high_never_enables_tf32(monkeypatch):
    """'high' must meet the TPU's HIGH (bf16x3, ~5e-6 of max|out|); TF32
    (10-bit inputs, ~3.5e-4) does not, so no float32 product of matmul or
    cmatmul may run with TF32 enabled, whatever the caller set: the flag
    is read at every matmul call inside, with the global flag turned on.
    'high' on the CPU is the fp32 product."""
    from torch.overrides import TorchFunctionMode

    seen = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "__matmul__",
                                                 "mm", "bmm"):
                seen.append(torch.backends.cuda.matmul.allow_tf32)
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(0)
    a, b = (torch.as_tensor(rng.normal(size=(40, 40)), dtype=torch.float32)
            for _ in range(2))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with Watch():
        for prec in ("high", "highest", None):
            got = gemm.matmul(a, b, prec)
            gemm.cmatmul(torch.complex(a, b), a, prec)
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.equal(got, a @ b)


@pytest.mark.parametrize("shape", [(256, 256, 172), (40, 33, 17)])
def test_gemm_default_is_the_tpu_default(shape):
    """'default' = fp32 product of bf16-rounded inputs, no output rounding:
    matmul and cmatmul (real x complex and complex x complex, batched)
    within 1e-5 of max|out| of the float64 emulation."""
    m, k, n = shape
    rng = np.random.default_rng(1)
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    a, b = f(m, k), f(k, n)
    ca, cb = torch.complex(f(2, m, k), f(2, m, k)), torch.complex(f(k, n),
                                                                f(k, n))
    for got, want in ((gemm.matmul(a, b, "default"), bf16_emulation(a, b)),
                      (gemm.cmatmul(a, cb, "default"), bf16_emulation(a, cb)),
                      (gemm.cmatmul(ca, cb, "default"),
                       bf16_emulation(ca, cb))):
        assert got.dtype in (torch.float32, torch.complex64)
        err = float((got.to(want.dtype) - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())



def test_gemm_default_dtype_rule():
    """'default' rounds a float32 pair, a bf16 table against float32 on
    either side, and a float32 left operand against float64, to the same
    product; a complex operand is never rounded (that would drop its
    imaginary part), so real x complex raises as torch's matmul does."""
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.normal(size=(24, 24)), dtype=torch.float32)
    want = gemm.matmul(a, a, "default")
    exact = bf16_emulation(a, a)
    assert float((want - exact).abs().max()) <= 1e-5 * float(
        exact.abs().max())
    for x, y in ((a, a.bfloat16()), (a.bfloat16(), a), (a, a.double())):
        got = gemm.matmul(x, y, "default")
        assert got.dtype == torch.float32 and torch.equal(got, want)
    c = torch.complex(a, a)
    for x, y in ((a, c), (c, a)):
        with pytest.raises(RuntimeError):
            gemm.matmul(x, y, "default")

def test_state_helpers():
    st = tstate.zeros_state(4, 5, dtype=torch.float64, history=True)
    assert st.u_prev is st.u and st.p.shape == (4, 5)
    assert st.astype(torch.float32).v_prev.dtype == torch.float32
    d = tstate.state_to_numpy(tstate.zeros_state(3, 3))
    assert sorted(d) == ["p", "u", "v"]
