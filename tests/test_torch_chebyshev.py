"""The Chebyshev family of the port against ns_tpu, on the CPU.

The port's `ops/cheb.py` (a copy) builds the same operators bitwise; its
`ops/parity.py` applies and solves with them as the JAX module does
(float64, <= 1e-12); `solvers/chorin_spectral.py` steps as the JAX solver
does: the quirk mode against the committed goldens at the JAX tests'
bounds, the corrected dense and parity engines against ns_tpu after 5
steps (<= 1e-10 of the field's max), the cached step bitwise equal to the
plain one, and every config error raised alike. Inputs are numpy arrays
from a seed; sizes are small (16-28, 51 for the goldens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.core.state import FlowState as JState
from ns_tpu.ops import cheb as j_cheb
from ns_tpu.ops import parity as j_parity
from ns_tpu.solvers import chorin_spectral as J
from ns_tpu_torch.core.bc import bcs_from_reference
from ns_tpu_torch.core.state import state_from_numpy, state_to_numpy
from ns_tpu_torch.ops import cheb, gemm, parity
from ns_tpu_torch.solvers import chorin_spectral as T
from tests.conftest import load_golden

CPU = "cpu"


def lid_bcs(nx, ny, lid=1.0):
    """The JAX parity tests' lid cavity (the lid on 'top')."""
    dx, dy = 2.0 / nx, 2.0 / ny
    u_bc = [j_dirichlet(0.0, "left", dx, dy),
            j_dirichlet(0.0, "right", dx, dy),
            j_dirichlet(0.0, "bottom", dx, dy),
            j_dirichlet(lid, "top", dx, dy)]
    v_bc = [j_dirichlet(0.0, s, dx, dy)
            for s in ("left", "right", "bottom", "top")]
    return u_bc, v_bc


def ref_cavity_bcs():
    """The reference preset's cavity (ns_tpu/cli/run_solver.py)."""
    u_bc = [j_dirichlet(0, "left"), j_dirichlet(1, "right"),
            j_dirichlet(0, "top"), j_dirichlet(0, "bottom")]
    v_bc = [j_dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    return u_bc, v_bc


def fields(nx, ny, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(scale=0.1, size=(nx, ny))
            for k in ("u", "v", "p", "u_prev", "v_prev")}


def jax_state(f):
    return JState(**{k: jnp.asarray(v) for k, v in f.items()})


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# --- ops/cheb.py -------------------------------------------------------------

@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("n", [16, 17, 51])
def test_cheb_copy_is_bitwise(n, quirk):
    np.testing.assert_array_equal(cheb.gauss_lobatto(n),
                                  j_cheb.gauss_lobatto(n))
    np.testing.assert_array_equal(cheb.gauss_lobatto(n, 2),
                                  j_cheb.gauss_lobatto(n, 2))
    np.testing.assert_array_equal(cheb.t_matrix(n), j_cheb.t_matrix(n))
    for name in ("bar_c", "inv_t_matrix", "d_matrix", "d_sqr_matrix",
                 "d_matrix_pn_minus_2"):
        np.testing.assert_array_equal(
            getattr(cheb, name)(n, quirk_compat=quirk),
            getattr(j_cheb, name)(n, quirk_compat=quirk), err_msg=name)
    M = cheb.d_sqr_matrix(n, quirk_compat=False)[1:-1, 1:-1]
    for a, b in zip(cheb.eig_real(M, "m"), j_cheb.eig_real(M, "m")):
        np.testing.assert_array_equal(a, b)


def test_cheb_operators_match_reference_golden():
    g = load_golden("chorin_spectral_ops.npz")
    N = 51
    np.testing.assert_array_equal(cheb.t_matrix(N), g["Tx"])
    np.testing.assert_array_equal(cheb.inv_t_matrix(N), g["Tx_inv"])
    np.testing.assert_array_equal(cheb.d_matrix(N), g["Dx"])
    np.testing.assert_array_equal(cheb.d_sqr_matrix(N), g["Dx_sqr"])
    np.testing.assert_array_equal(cheb.d_matrix_pn_minus_2(N), g["DPx"])
    np.testing.assert_array_equal(
        cheb.d_matrix(N)[1:-1, 1:-1] @ cheb.d_matrix_pn_minus_2(N),
        g["DxDPx"])


def test_eig_real_guard_raises_alike():
    M = np.array([[0.0, -1.0], [1.0, 0.0]])  # rotation: spectrum +-i
    for mod in (cheb, j_cheb):
        with pytest.raises(ValueError, match="complex eigenvalues"):
            mod.eig_real(M, "rot")


# --- ops/parity.py -----------------------------------------------------------

def test_reversal_parity_matches_jax():
    for n in (16, 17, 20):
        for quirk in (True, False):
            for M in (cheb.d_matrix(n, quirk), cheb.d_sqr_matrix(n, quirk),
                      cheb.d_matrix_pn_minus_2(n, quirk),
                      cheb.d_matrix(n, quirk)[1:-1, :]):
                assert parity.reversal_parity(M) == \
                    j_parity.reversal_parity(M)
    assert parity.reversal_parity(cheb.d_matrix(20, False)) == -1
    assert parity.reversal_parity(cheb.d_sqr_matrix(20, False)) == +1
    assert parity.reversal_parity(cheb.d_matrix(20, True)) is None


@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("n", [16, 17])
def test_parity_apply_matches_jax(n, sign):
    rng = np.random.default_rng(n + sign)
    M = rng.normal(size=(n - 2, n))
    M = 0.5 * (M + sign * M[::-1, ::-1])
    X = rng.normal(size=(2, n, 7))
    Y = rng.normal(size=(3, 5, n))
    for side, A in (("left", X), ("right", Y)):
        got = parity.make_parity_apply(M, torch.float64, side,
                                       device=CPU)(torch.tensor(A))
        want = j_parity.make_parity_apply(M, jnp.float64, side)(
            jnp.asarray(A))
        dense = M @ A if side == "left" else A @ M.T
        assert rel(got, want) <= 1e-12, side
        np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="no reversal parity"):
        parity.make_parity_apply(rng.normal(size=(n, n)), torch.float64)


def _helmholtz(n):
    return cheb.d_sqr_matrix(n, quirk_compat=False)[1:-1, 1:-1]


@pytest.mark.parametrize("n", [16, 17])
def test_parity_eig_matches_jax(n):
    M = _helmholtz(n)
    t = parity.ParityEig(M, "h", torch.float64, device=CPU)
    j = j_parity.ParityEig(M, "h", jnp.float64)
    np.testing.assert_array_equal(t.lam.numpy(), np.asarray(j.lam))
    F = np.random.default_rng(n).normal(size=(n - 2, n - 2))
    for axis in (-2, -1):
        g_t = t.forward(torch.tensor(F), axis)
        g_j = j.forward(jnp.asarray(F), axis)
        assert rel(g_t, g_j) <= 1e-12
        assert rel(t.inverse(g_t, axis), j.inverse(g_j, axis)) <= 1e-12
        assert rel(t.inverse(g_t, axis), F) <= 1e-12
    assert t.same_blocks(parity.ParityEig(M, "h2", torch.float64,
                                          device=CPU))
    with pytest.raises(ValueError, match="not reversal-even"):
        parity.ParityEig(cheb.d_matrix(n, False)[1:-1, 1:-1], "odd",
                         torch.float64)


@pytest.mark.parametrize("form", ["solve", "solve_composed"])
@pytest.mark.parametrize("nx,ny", [(16, 16), (17, 20)])
def test_parity_eig_2d_matches_jax(nx, ny, form):
    Mx, My = _helmholtz(nx), _helmholtz(ny)
    t = parity.ParityEig2D(
        parity.ParityEig(Mx, "x", torch.float64, device=CPU),
        parity.ParityEig(My, "y", torch.float64, device=CPU))
    j = j_parity.ParityEig2D(j_parity.ParityEig(Mx, "x", jnp.float64),
                             j_parity.ParityEig(My, "y", jnp.float64))
    fn = lambda lx, ly: 2.0 - 1e-3 * lx - 1e-3 * ly
    r_t = tuple(1.0 / d for d in t.denoms(fn))
    r_j = tuple(1.0 / d for d in j.denoms(fn))
    for a, b in zip(r_t, r_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if form == "solve_composed":
        r_t, r_j = t.full_recip(r_t), j.full_recip(r_j)
    F = np.random.default_rng(nx * ny).normal(size=(2, nx - 2, ny - 2))
    got = getattr(t, form)(torch.tensor(F), r_t)
    want = getattr(j, form)(jnp.asarray(F), r_j)
    assert rel(got, want) <= 1e-12
    for q_t, q_j in zip(t.quadrants(torch.tensor(F)),
                        j.quadrants(jnp.asarray(F))):
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(t.assemble(*t.quadrants(
        torch.tensor(F))).numpy(), F, rtol=0, atol=1e-15)


# --- solvers/chorin_spectral.py ----------------------------------------------

def test_quirk_rollout_matches_reference_golden_3_steps():
    """The JAX test's bounds (tests/test_chorin_spectral.py): p at step 0
    to 1e-11 relative, u and v to 1e-7 of the cancellation scale dt*|p|,
    and the same growth envelope at steps 1 and 2."""
    nx = ny = 51
    z = np.zeros((nx, ny))
    sys_ = T.NavierStokesSystem(z, z, z, *ref_cavity_bcs(), nt=3, nit=200,
                                nx=nx, ny=ny, dt=0.001, rho=1, nu=0.1,
                                beta=1.25, device=CPU)
    u, v, p = (a.numpy() for a in sys_.simulate())
    g = load_golden("chorin_spectral_nt3.npz")
    p_scale = np.abs(g["p"][0]).max()
    assert np.abs(p[0] - g["p"][0]).max() / p_scale < 1e-11
    for mine, ref in ((u, g["u"]), (v, g["v"])):
        assert np.abs(mine[0] - ref[0]).max() / (0.001 * p_scale) < 1e-7
    for t in (1, 2):
        assert 0.1 < np.abs(u[t]).max() / np.abs(g["u"][t]).max() < 10.0


def test_quirk_deflated_rollout_matches_golden_6_steps():
    nx = ny = 51
    z = np.zeros((nx, ny))
    sys_ = T.NavierStokesSystem(z, z, z, *ref_cavity_bcs(), nt=6, nit=200,
                                nx=nx, ny=ny, dt=0.001, rho=1, nu=0.1,
                                beta=1.25, quirk_compat=True,
                                deflate_pressure_nullspace=True, device=CPU)
    u, v, p = (a.numpy() for a in sys_.simulate())
    g = load_golden("chorin_spectral_deflated_nt6.npz")
    for t in range(6):
        for mine, key in ((u, "u"), (v, "v"), (p, "p")):
            assert rel(mine[t], g[key][t]) < 5e-11, (key, t)


def _both_steps(cfg_kw, u_bc, v_bc):
    js = jax.jit(J.make_step(J.ChorinSpectralConfig(**cfg_kw), u_bc, v_bc,
                             dtype=jnp.float64))
    ts = T.make_step(T.ChorinSpectralConfig(**cfg_kw),
                     bcs_from_reference(u_bc), bcs_from_reference(v_bc),
                     dtype=torch.float64, device=CPU)
    return js, ts


def _five_steps(js, ts, f):
    a, b = jax_state(f), state_from_numpy(f, device=CPU)
    for _ in range(5):
        a, b = js(a), ts(b)
    return a, b


@pytest.mark.parametrize("form", ["composed", "quadrant"])
@pytest.mark.parametrize("nx,ny", [(24, 24), (25, 25), (24, 28)])
def test_corrected_parity_engine_matches_jax(nx, ny, form):
    kw = dict(nx=nx, ny=ny, dt=1e-3, nu=0.1, quirk_compat=False,
              deflate_pressure_nullspace=True, parity_split=True,
              parity_eig_form=form)
    js, ts = _both_steps(kw, *lid_bcs(nx, ny))
    assert ts.parity_split is True
    a, b = _five_steps(js, ts, fields(nx, ny, nx + ny))
    for k in "uvp":
        assert rel(getattr(b, k), getattr(a, k)) <= 1e-10, k


@pytest.mark.parametrize("nx,ny", [(24, 24), (17, 21), (25, 25)])
def test_corrected_dense_engine_matches_jax(nx, ny):
    """The dense engine with the pressure nullspace deflated (the corrected
    mode's default: without it the ~0 eigenvalue amplifies rounding, in
    either package, beyond any parity bound)."""
    kw = dict(nx=nx, ny=ny, dt=1e-3, nu=0.1, quirk_compat=False,
              deflate_pressure_nullspace=True)
    js, ts = _both_steps(kw, *lid_bcs(nx, ny))
    assert ts.parity_split is False
    a, b = _five_steps(js, ts, fields(nx, ny, 5))
    for k in "uvp":
        assert rel(getattr(b, k), getattr(a, k)) <= 1e-10, k


@pytest.mark.parametrize("parity_split", [False, True])
def test_corrected_neumann_matches_jax(parity_split):
    nx = ny = 16
    dx = dy = 2.0 / nx
    u_bc = [j_neumann(0.0, "left", dx, dy), j_neumann(0.0, "right", dx, dy),
            j_dirichlet(0.0, "bottom", dx, dy),
            j_dirichlet(0.0, "top", dx, dy)]
    v_bc = [j_dirichlet(0.0, s, dx, dy)
            for s in ("left", "right", "bottom", "top")]
    kw = dict(nx=nx, ny=ny, quirk_compat=False,
              deflate_pressure_nullspace=True, parity_split=parity_split)
    js, ts = _both_steps(kw, u_bc, v_bc)
    a, b = _five_steps(js, ts, fields(nx, ny, 3))
    for k in "uvp":
        assert rel(getattr(b, k), getattr(a, k)) <= 1e-10, k


@pytest.mark.parametrize("mode", ["dense", "parity", "quirk"])
@pytest.mark.parametrize("n", [16, 17])
def test_cached_step_is_bitwise_the_plain_step(n, mode):
    if mode == "quirk" and n % 2 == 0:
        n += 1  # the quirk operators build at odd sizes only
    u_bc, v_bc = (bcs_from_reference(b) for b in ref_cavity_bcs())
    cfg = T.ChorinSpectralConfig(
        nt=5, nx=n, ny=n, dt=1e-4, nu=0.1, quirk_compat=mode == "quirk",
        deflate_pressure_nullspace=mode != "quirk",
        parity_split=True if mode == "parity" else None)
    step = T.make_step(cfg, u_bc, v_bc, device=CPU)
    s0 = state_from_numpy(fields(n, n, n), device=CPU)
    plain, cached = s0, (s0, step.seed(s0))
    for _ in range(5):
        plain, cached = step(plain), step.cached(*cached)
    assert (cached[1] is None) == (mode == "quirk")
    for k in "uvp":
        assert torch.equal(getattr(plain, k), getattr(cached[0], k)), k
    seqs = T.simulate(cfg, s0, step)
    assert torch.equal(seqs[0][-1], plain.u)


def _bad_cfg_cases():
    u_bc, v_bc = ref_cavity_bcs()
    asym = [j_dirichlet(0.0, "left"), j_dirichlet(0.0, "right"),
            j_dirichlet(0.0, "bottom"),
            j_neumann(1.0, "top", 0.1, 0.1)]
    return [
        ("missing side", ValueError, "all four sides",
         lambda m: m._process_bcs(u_bc[:3])),
        ("neumann in quirk mode", NotImplementedError, "Dirichlet BCs only",
         lambda m: m._process_bcs([j_neumann(0, "left", 0.1, 0.1)]
                                  + u_bc[1:])),
        ("even quirk grid", ValueError, "ODD grid sizes",
         lambda m: m.make_step(m.ChorinSpectralConfig(nx=24, ny=24),
                               u_bc, v_bc, **_cpu(m))),
        ("parity with quirk", ValueError, "needs quirk_compat=False",
         lambda m: m.make_step(m.ChorinSpectralConfig(
             nx=17, ny=17, parity_split=True), u_bc, v_bc, **_cpu(m))),
        ("parity form", ValueError, "parity_eig_form",
         lambda m: m.make_step(m.ChorinSpectralConfig(
             nx=16, ny=16, quirk_compat=False, parity_split=True,
             parity_eig_form="diagonal"), u_bc, v_bc, **_cpu(m))),
        ("parity with asymmetric BCs", ValueError, "reversal parity",
         lambda m: m.make_step(m.ChorinSpectralConfig(
             nx=16, ny=16, quirk_compat=False, parity_split=True),
             asym, v_bc, **_cpu(m))),
    ]


def _cpu(m):
    return {"device": CPU} if m is T else {}


@pytest.mark.parametrize("case", _bad_cfg_cases(), ids=lambda c: c[0])
def test_config_errors_raise_alike(case):
    _, exc, match, call = case
    msgs = []
    for mod in (J, T):
        with pytest.raises(exc, match=match) as e:
            call(mod)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_parity_resolution_matches_jax():
    """Auto takes the parity engine at interior >= 192 in corrected mode
    only; explicit False forces dense."""
    u_bc, v_bc = ref_cavity_bcs()
    for n, quirk, ps in ((16, False, None), (16, False, True),
                         (16, False, False), (194, False, None),
                         (193, False, None), (17, True, None),
                         (194, False, False)):
        kw = dict(nx=n, ny=n, quirk_compat=quirk, parity_split=ps)
        j_ops = J._setup(J.ChorinSpectralConfig(**kw), u_bc, v_bc,
                         jnp.float64)
        t_ops = T._setup(T.ChorinSpectralConfig(**kw),
                         bcs_from_reference(u_bc), bcs_from_reference(v_bc),
                         torch.float64, CPU)
        got = T._resolve_parity_split(T.ChorinSpectralConfig(**kw),
                                      t_ops[0], t_ops[1], t_ops[3])
        want = J._resolve_parity_split(J.ChorinSpectralConfig(**kw),
                                       j_ops[0], j_ops[1], j_ops[3])
        assert got == want == (ps is True or (ps is None and not quirk
                                              and n - 2 >= 192)), kw


def test_state_from_jax_steps_on_in_the_port():
    """A JAX FlowState read back as numpy steps on in the port; the port's
    AB cache is re-seeded by step.seed."""
    nx = ny = 20
    u_bc, v_bc = lid_bcs(nx, ny)
    kw = dict(nx=nx, ny=ny, dt=1e-3, nu=0.1, quirk_compat=False,
              deflate_pressure_nullspace=True, parity_split=True)
    js, ts = _both_steps(kw, u_bc, v_bc)
    a = jax_state(fields(nx, ny, 9))
    for _ in range(3):
        a = js(a)
    mid = state_to_numpy(a)
    for _ in range(2):
        a = js(a)
    b = state_from_numpy(mid, device=CPU)
    cache = ts.seed(b)
    for _ in range(2):
        b, cache = ts.cached(b, cache)
    for k in "uvp":
        assert rel(getattr(b, k), getattr(a, k)) <= 1e-10, k


def test_system_matches_jax_system():
    """NavierStokesSystem with its defaults (deflation = not quirk_compat)
    and a divergence-free decaying dipole (the JAX test's), 20 steps."""
    n = 21
    bc0 = [j_dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    x = cheb.gauss_lobatto(n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    u0 = 2 * (1 - X**2) ** 2 * (1 - Y**2) * (-2 * Y)
    v0 = -2 * (1 - X**2) * (-2 * X) * (1 - Y**2) ** 2
    kw = dict(nt=20, nx=n, ny=n, dt=0.001, rho=1, nu=0.1,
              quirk_compat=False)
    j = J.NavierStokesSystem(u0, v0, np.zeros((n, n)), bc0, bc0,
                             dtype=jnp.float64, **kw)
    t = T.NavierStokesSystem(u0, v0, np.zeros((n, n)), bc0, bc0,
                             device=CPU, **kw)
    assert t.cfg.deflate_pressure_nullspace is True
    for a, b in zip(t.simulate(), j.simulate()):
        assert a.shape == (20, n, n)
        assert rel(a, b) <= 1e-10
    D = cheb.d_matrix(n, quirk_compat=False)
    uu, vv = (f[-1].numpy() for f in t.simulate()[:2])
    div = D[1:-1, :] @ uu[:, 1:-1] + vv[1:-1, :] @ D[1:-1, :].T
    assert np.abs(div).max() < 1e-10


class _CountProducts(torch.overrides.TorchFunctionMode):
    """Counts the matrix products torch runs."""

    PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.Tensor.__matmul__,
                torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm,
                torch.einsum, torch.Tensor.__rmatmul__}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("mode", ["quirk", "dense", "parity"])
def test_every_product_takes_the_step_precision(monkeypatch, mode, prec):
    """The JAX step traces under jax.default_matmul_precision, so every
    product (GEMMs and matvecs) takes cfg.matmul_precision. Here every
    product of a float32 step goes through ops/gemm.py::matmul with that
    precision: its calls equal the products torch runs, and at 'default'
    the GEMM-only constants are bf16 tables, rounded once."""
    seen = []
    real = gemm.matmul

    def spy(a, b, precision):
        seen.append(precision)
        return real(a, b, precision)

    monkeypatch.setattr(T, "matmul", spy)
    monkeypatch.setattr(parity, "matmul", spy)
    n = 17
    u_bc, v_bc = (bcs_from_reference(b) for b in ref_cavity_bcs())
    cfg = T.ChorinSpectralConfig(
        nx=n, ny=n, matmul_precision=prec, quirk_compat=mode == "quirk",
        deflate_pressure_nullspace=mode != "quirk",
        parity_split=mode == "parity")
    step = T.make_step(cfg, u_bc, v_bc, dtype=torch.float32, device=CPU)
    s0 = state_from_numpy(fields(n, n, 1), device=CPU, dtype=torch.float32)
    seen.clear()
    with _CountProducts() as count:
        out = step(s0)
    assert seen and set(seen) == {prec}
    assert count.n == len(seen)
    assert all(bool(torch.isfinite(getattr(out, k)).all()) for k in "uvp")
    if mode == "parity":
        op = parity.ParityEig(cheb.d_sqr_matrix(n, False)[1:-1, 1:-1], "h",
                              torch.float32, prec, CPU)
        want = torch.bfloat16 if prec == "default" else torch.float32
        assert op.Ve.dtype == want and op.lam.dtype == torch.float32


def test_default_precision_rounds_the_products_inputs():
    """At 'default' the float32 step rounds every product's inputs to bf16
    (fp32 sums): it departs from 'highest' by the bf16 rounding, far more
    than float32's own rounding and far less than O(1)."""
    n = 25
    u_bc, v_bc = (bcs_from_reference(b) for b in lid_bcs(n, n))
    f = fields(n, n, 2)
    out = {}
    for prec in ("highest", "default"):
        cfg = T.ChorinSpectralConfig(nx=n, ny=n, dt=1e-3, nu=0.1,
                                     matmul_precision=prec,
                                     quirk_compat=False,
                                     deflate_pressure_nullspace=True,
                                     parity_split=True)
        step = T.make_step(cfg, u_bc, v_bc, dtype=torch.float32, device=CPU)
        out[prec] = step(state_from_numpy(f, device=CPU,
                                          dtype=torch.float32)).u
    ref = T.make_step(T.ChorinSpectralConfig(
        nx=n, ny=n, dt=1e-3, nu=0.1, quirk_compat=False,
        deflate_pressure_nullspace=True, parity_split=True), u_bc, v_bc,
        device=CPU)(state_from_numpy(f, device=CPU)).u
    assert rel(out["highest"], ref) < 1e-4
    assert 1e-4 < rel(out["default"], ref) < 1e-1


def test_make_step_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u_bc, v_bc = (bcs_from_reference(b) for b in ref_cavity_bcs())
    cfg = T.ChorinSpectralConfig(nx=17, ny=17)
    z = np.zeros((17, 17))
    for call in (lambda d: T.make_step(cfg, u_bc, v_bc, device=d),
                 lambda d: T.init_state(cfg, z, z, z, u_bc, v_bc, device=d),
                 lambda d: T.NavierStokesSystem(z, z, z, u_bc, v_bc, nt=1,
                                                nx=17, ny=17, device=d)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call(None)
        call("cpu")
