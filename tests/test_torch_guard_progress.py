"""The port's divergence guard and chunked progress rollout against ns_tpu.

`utils/guard.py::guarded_rollout` keeps its trip flag on the device and
selects old or new state each step; it must give the JAX rollout's frozen
frames and first bad step: on the JAX tests' toy step and on an unstable
chorin_fd run (explicit, dt = 0.2, float64). `utils/progress.py::
chunked_simulate` must give the plain rollout's frames, and reject a chunk
below 1 as the JAX function does.
"""

import builtins

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.core.bc import dirichlet as j_dirichlet
from ns_tpu.core.bc import neumann as j_neumann
from ns_tpu.solvers import chorin_fd as j_fd
from ns_tpu.utils import guard as j_guard
from ns_tpu.utils import progress as j_progress
from ns_tpu_torch.core.state import FlowState
from ns_tpu_torch.solvers import chorin_fd as t_fd
from ns_tpu_torch.solvers import chorin_spectral as t_cs
from ns_tpu_torch.solvers import spectral_periodic as t_sp
from ns_tpu_torch.utils import guard, progress

CPU = "cpu"


def cavity_bcs(n):
    h = 2.0 / (n - 1)
    u_bc = [j_dirichlet(0, "left"), j_dirichlet(1, "right"),
            j_dirichlet(0, "top"), j_dirichlet(0, "bottom")]
    v_bc = [j_dirichlet(0, s) for s in ("left", "right", "top", "bottom")]
    p_bc = [j_dirichlet(0, "top"), j_neumann(0, "bottom", h, h),
            j_neumann(0, "left", h, h), j_neumann(0, "right", h, h)]
    return u_bc, v_bc, p_bc


@pytest.mark.parametrize("factor,max_abs", [(2.0, 100.0), (0.5, 1e6),
                                            (-3.0, 50.0)])
def test_guarded_toy_rollout_matches_jax(factor, max_abs):
    """tests/test_utils_aux.py's toy step: the doubling map trips at step
    index 6 (2^7 = 128 > 100) and freezes at 64."""
    step_t = lambda s: factor * s
    step_j = lambda s: factor * s
    ft, st = guard.guarded_rollout(step_t, torch.tensor(1.0,
                                                        dtype=torch.float64),
                                   nt=12, max_abs=max_abs)
    fj, sj = j_guard.guarded_rollout(step_j, jnp.asarray(1.0), nt=12,
                                     max_abs=max_abs)
    assert bool(ft.bad) == bool(fj.bad)
    assert int(ft.first_bad_step) == int(fj.first_bad_step)
    assert ft.first_bad_step.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(ft.state) == float(fj.state)
    if factor == 2.0:
        assert int(ft.first_bad_step) == 6 and float(ft.state) == 64.0
    if factor == 0.5:
        assert int(ft.first_bad_step) == -1


def test_state_is_bad_matches_jax():
    cases = [{"u": np.ones((3, 3))}, {"u": np.array([np.nan])},
             {"u": np.array([1e9])}, {"u": np.array([-np.inf]),
                                      "v": np.zeros(2)},
             {"a": np.ones(2), "b": np.array([2e6])}]
    for c in cases:
        want = bool(j_guard.state_is_bad(
            {k: jnp.asarray(v) for k, v in c.items()}))
        got = guard.state_is_bad({k: torch.tensor(v) for k, v in c.items()})
        assert bool(got) == want
    # a FlowState with no history: None fields are left alone
    z = torch.zeros(4, 4)
    assert not bool(guard.state_is_bad(FlowState(u=z, v=z, p=z)))
    assert bool(guard.state_is_bad(FlowState(u=z, v=z + np.nan, p=z)))


def test_guarded_unstable_chorin_fd_matches_jax():
    """chorin_fd explicit at dt = 0.2 diverges: both guarded rollouts trip
    at the same step and freeze the same frames (float64)."""
    n, nt = 17, 12
    bcs = cavity_bcs(n)
    z = np.zeros((n, n))
    kw = dict(nt=nt, nit=50, nx=n, ny=n, dt=0.2, rho=1, nu=0.1,
              method="explicit")
    js = j_fd.NavierStokesSystem(z, z, z, *bcs, dtype=jnp.float64, **kw)
    ts = t_fd.NavierStokesSystem(z, z, z, *bcs, dtype=torch.float64,
                                 device=CPU, **kw)
    fj, sj = jax.jit(lambda s0: j_guard.guarded_rollout(
        js._step, s0, nt))(js.state0)
    ft, st = guard.guarded_rollout(ts._step, ts.state0, nt)
    assert bool(ft.bad) and bool(fj.bad)
    assert int(ft.first_bad_step) == int(fj.first_bad_step) > 0
    k = int(ft.first_bad_step)
    for name in ("u", "v", "p", "u_prev", "v_prev"):
        got, want = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
        assert got.shape == want.shape == (nt, n, n)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
        # frozen from the trip on
        for t in range(k, nt):
            np.testing.assert_array_equal(got[t], got[k - 1])


def _cheb_system():
    n = 17
    u_bc, v_bc, _ = cavity_bcs(n)
    z = np.zeros((n, n))
    return t_cs.NavierStokesSystem(z, z, z, u_bc, v_bc, nt=11, nx=n, ny=n,
                                   dt=1e-3, nu=0.1, quirk_compat=False,
                                   device=CPU)


def _fd_system():
    n = 17
    z = np.zeros((n, n))
    return t_fd.NavierStokesSystem(z, z, z, *cavity_bcs(n), nt=11, nx=n,
                                   ny=n, method="explicit",
                                   dtype=torch.float64, device=CPU)


@pytest.mark.parametrize("chunk", [1, 4, 11, 25])
@pytest.mark.parametrize("make", [_cheb_system, _fd_system],
                         ids=["chorin_spectral", "chorin_fd"])
def test_chunked_simulate_equals_simulate(make, chunk):
    sys_ = make()
    outs, final = progress.chunked_simulate(
        sys_._step, sys_.state0, sys_.cfg.nt,
        lambda s: {"u": s.u, "v": s.v, "p": s.p}, chunk=chunk,
        progress=False)
    for key, seq in zip("uvp", sys_.simulate()):
        assert outs[key].shape == tuple(seq.shape)
        np.testing.assert_array_equal(outs[key], seq.numpy())
    np.testing.assert_array_equal(final.u.numpy(), outs["u"][-1])


def test_chunked_simulate_periodic_carry():
    sys_ = t_sp.NavierStokesSystem(
        t_sp.taylor_green_vorticity(t_sp.SpectralPeriodicConfig(nx=16,
                                                                ny=16)),
        nt=5, nx=16, ny=16, dtype="float64", device=CPU)
    outs, _ = progress.chunked_simulate(
        lambda c: sys_._step(c)[0], sys_.carry0, 5,
        lambda c: dict(zip("uvp", sys_._extract(c[0]))), chunk=2,
        progress=False)
    for key, seq in zip("uvp", sys_.simulate()):
        np.testing.assert_array_equal(outs[key], seq.numpy())


def test_chunk_below_one_raises_alike():
    msgs = []
    for fn, s0 in ((progress.chunked_simulate, torch.zeros(2)),
                   (j_progress.chunked_simulate, jnp.zeros(2))):
        with pytest.raises(ValueError, match="chunk must be >= 1") as e:
            fn(lambda s: s, s0, 3, lambda s: {"s": s}, chunk=0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_progress_without_tqdm_prints_a_line_a_chunk(monkeypatch, capsys):
    real_import = builtins.__import__

    def no_tqdm(name, *args, **kwargs):
        if name == "tqdm":
            raise ImportError("no tqdm")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tqdm)
    outs, final = progress.chunked_simulate(
        lambda s: s + 1, torch.zeros(()), 7, lambda s: {"s": s}, chunk=3,
        desc="toy")
    assert capsys.readouterr().out.splitlines() == [
        "toy: step 3/7", "toy: step 6/7", "toy: step 7/7"]
    np.testing.assert_array_equal(outs["s"], np.arange(1, 8))
    assert float(final) == 7.0
    outs, _ = progress.chunked_simulate(lambda s: s, torch.zeros(2), 0,
                                        lambda s: {"s": s}, progress=False)
    assert outs["s"].shape == (0, 2)
