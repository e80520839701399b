"""The port's single-device leftovers against the JAX package: the public
`core` and `io` names, the npz interchange, spatial_coarsen, utils/host,
utils/profiling (named scopes in chorin_fd's step, trace, timed), the NaN
tripwire and shadow_check.

  - spatial_coarsen against ns_tpu's on the same seeded rollouts, bitwise
    (numpy both sides), with its quirk rule (tests/test_round2_cleanup.py:
    67);
  - shadow_check: the three cases of tests/test_shadow.py, and the JAX
    function's result structure;
  - timed: tests/test_utils_aux.py:79;
  - run_solver's npz goes through save_rollout and holds what np.savez of
    the fields held before (keys, order, arrays).
"""

import contextlib
import glob
import json
import zipfile

import numpy as np
import pytest
import torch

from ns_tpu_torch.cli.run_solver import cavity_bcs
from ns_tpu_torch.solvers import chorin_fd
from ns_tpu_torch.utils import guard, host, profiling


def test_core_exports_match_jax():
    import ns_tpu.core as jcore
    import ns_tpu_torch.core as tcore
    from ns_tpu_torch.core import (BC, DirichletBoundaryCondition,  # noqa
                                   FlowState, NeumannBoundaryCondition,
                                   apply_bcs, dirichlet, neumann)
    public = lambda m: {n for n in vars(m) if not n.startswith("_")}  # noqa
    assert public(jcore) - {"bc", "state"} <= public(tcore)
    bc = dirichlet(1.0, "left")
    a = apply_bcs(torch.zeros(3, 3), [bc])
    assert a[0].tolist() == [1.0, 1.0, 1.0]
    assert isinstance(bc, BC)


def test_io_exports_and_npz_roundtrip(tmp_path):
    from ns_tpu.io import npz as jnpz
    from ns_tpu_torch.io import load_rollout, save_rollout, spatial_coarsen  # noqa
    from ns_tpu_torch.io import npz as tnpz
    assert tnpz.CHORIN_FD_DATA_FILE == jnpz.CHORIN_FD_DATA_FILE
    assert tnpz.DIRECT_FD_DATA_FILE == jnpz.DIRECT_FD_DATA_FILE
    rng = np.random.default_rng(0)
    u, v, p = rng.normal(size=(3, 4, 6, 5))
    path = save_rollout(str(tmp_path / "sub" / "r.npz"), u, v, p)
    for got, want in zip(load_rollout(path), (u, v, p)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(jnpz.load_rollout(path), (u, v, p)):
        np.testing.assert_array_equal(got, want)
    jpath = jnpz.save_rollout(str(tmp_path / "j.npz"), u, v, p)
    for got, want in zip(load_rollout(jpath), (u, v, p)):
        np.testing.assert_array_equal(got, want)


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i)) for i in z.infolist()]


def test_run_solver_npz_is_what_savez_wrote(tmp_path):
    """save_npz writes the (u, v, p) triple through save_rollout: the same
    members, in the same order, with the same bytes, as np.savez of the
    fields; the 3D set keeps its four keys."""
    from ns_tpu_torch.cli import run_solver
    rng = np.random.default_rng(1)
    fields = dict(zip("uvp", rng.normal(size=(3, 2, 4, 4))))
    run_solver.save_npz(str(tmp_path / "a.npz"), **fields)
    np.savez(str(tmp_path / "b.npz"), **fields)
    assert _npz_members(tmp_path / "a.npz") == _npz_members(tmp_path /
                                                            "b.npz")
    out = str(tmp_path / "c.npz")
    summary = run_solver.main(["direct_fd", "--device", "cpu", "--nt", "3",
                               "--nx", "12", "--out", out])
    assert summary["out"] == out
    with np.load(out) as d:
        assert list(d.keys()) == ["u", "v", "p"]
    four = dict(zip("uvwp", rng.normal(size=(4, 2, 3, 3, 3))))
    run_solver.save_npz(str(tmp_path / "d.npz"), **four)
    with np.load(str(tmp_path / "d.npz")) as d:
        assert list(d.keys()) == ["u", "v", "w", "p"]


@pytest.mark.parametrize("agg", [(4, 4), (2, 2), (4, 2), (8, 4)])
def test_spatial_coarsen_matches_jax(agg):
    from ns_tpu.io.coarsen import spatial_coarsen as jcoarsen
    from ns_tpu_torch.io import spatial_coarsen
    T, nx, ny = 3, 16, 16
    X, Y = np.meshgrid(np.linspace(0, 2, nx), np.linspace(0, 2, ny),
                       indexing="ij")
    seqs = np.random.default_rng(3).normal(size=(3, T, nx, ny))
    for quirk in (True, False):
        got = spatial_coarsen(X, Y, *seqs, agg_x=agg[0], agg_y=agg[1],
                              quirk_compat=quirk)
        want = jcoarsen(X, Y, *seqs, agg_x=agg[0], agg_y=agg[1],
                        quirk_compat=quirk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_coarsen_quirk_rejects_agg_x_lt_agg_y():
    """tests/test_round2_cleanup.py:67: the reference raises IndexError for
    agg_x < agg_y; the corrected mode handles it."""
    from ns_tpu_torch.io import spatial_coarsen
    T, nx, ny = 2, 8, 8
    X, Y = np.meshgrid(np.linspace(0, 2, nx), np.linspace(0, 2, ny),
                       indexing="ij")
    seq = np.random.default_rng(0).normal(size=(T, nx, ny))
    with pytest.raises(IndexError):
        spatial_coarsen(X, Y, seq, seq, seq, agg_x=2, agg_y=4,
                        quirk_compat=True)
    _, _, u, _, _ = spatial_coarsen(X, Y, seq, seq, seq, agg_x=2, agg_y=4,
                                    quirk_compat=False)
    assert u.shape == (T, 4, 2)


def test_host_sync_and_to_host():
    tree = {"a": torch.ones(2, 3), "b": [torch.zeros(2, dtype=torch.complex128),
                                        None], "c": 3}
    assert host.sync(tree) is tree
    out = host.to_host(tree)
    assert isinstance(out["a"], np.ndarray) and out["a"].shape == (2, 3)
    assert out["b"][0].dtype == np.complex128 and out["b"][1] is None
    assert out["c"] == 3


def test_timed_blocks():
    """tests/test_utils_aux.py::test_timed_blocks."""
    secs, out = profiling.timed(lambda x: x * 2, torch.ones(8, 8), iters=3,
                                warmup=1)
    assert secs > 0 and out.shape == (8, 8)


def _chorin_step(nx=17):
    cfg = chorin_fd.ChorinFDConfig(nt=2, nit=20, nx=nx, ny=nx, dt=1e-3,
                                   rho=1.0, nu=0.1, beta=1.25,
                                   method="explicit")
    u_bc, v_bc, p_bc = cavity_bcs(cfg.dx, cfg.dy)
    z = np.zeros((nx, nx))
    step = chorin_fd.make_step(cfg, u_bc, v_bc, p_bc, dtype=torch.float64,
                               device="cpu")
    return step, chorin_fd.init_state(cfg, z, z, z, u_bc, v_bc, p_bc,
                                      dtype=torch.float64, device="cpu")


def test_trace_holds_chorin_fd_scopes(tmp_path):
    """trace writes a Chrome trace under log_dir with the three named
    scopes of chorin_fd's step (ns_tpu/solvers/chorin_fd.py:326, :361,
    :416)."""
    step, s = _chorin_step()
    with profiling.trace(str(tmp_path)):
        step(s)
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    for scope in ("chorin_fd.predictor", "chorin_fd.pressure",
                  "chorin_fd.correction"):
        assert scope in names


def test_named_scope_keeps_the_step_bitwise_and_exportable():
    step, s = _chorin_step()
    a = step(s)
    with profiling.named_scope("outer"):
        b = step(s)
    for f in ("u", "v", "p"):
        assert torch.equal(getattr(a, f), getattr(b, f))

    class M(torch.nn.Module):
        def forward(self, x):
            with profiling.named_scope("scope"):
                return x * 2

    prog = torch.export.export(M(), (torch.ones(3),))
    assert "record_function" not in str(prog.graph)
    assert torch.equal(prog.module()(torch.ones(3)), torch.full((3,), 2.0))


def test_named_scope_does_nothing_off_a_profile():
    """Off a profile a scope is a nullcontext (no record_function, no NVTX
    push); under trace it records."""
    assert isinstance(profiling.named_scope("x"), contextlib.nullcontext)
    with torch.profiler.profile() as prof:
        assert not isinstance(profiling.named_scope("x"),
                              contextlib.nullcontext)
        with profiling.named_scope("recorded"):
            torch.ones(2) + 1
    assert "recorded" in {e.name for e in prof.events()}


def test_enable_nan_checks_raises_at_the_op():
    x = torch.tensor([-1.0, 1.0])
    assert torch.isnan(torch.log(x)).any()
    guard.enable_nan_checks()
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x)
        torch.sqrt(torch.tensor([4.0]))        # clean ops run
        with pytest.raises(FloatingPointError, match="aten.div"):
            torch.zeros(2) / torch.zeros(2)
    finally:
        guard.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(x)).any()     # off again: no raise


def test_shadow_check_flags_precision_loss():
    """tests/test_shadow.py: summing many small numbers loses float32
    precision the float64 shadow keeps."""
    x = torch.full((1_000_000,), 0.1, dtype=torch.float32)
    lo, hi, devs = guard.shadow_check(lambda x: torch.cumsum(x, 0)[-1:], x)
    assert lo.dtype == torch.float32 and hi.dtype == torch.float64
    assert isinstance(devs, float) and devs > 1e-3


def test_shadow_check_agrees_on_stable_fn():
    x = torch.linspace(0, 1, 64, dtype=torch.float32)
    _, _, devs = guard.shadow_check(lambda x: x * 2.0 + 1.0, x)
    assert devs < 1e-6


def test_shadow_check_sees_imaginary_deviation():
    """Complex outputs deviate on |a - b| over both components."""
    x = torch.linspace(0.0, 1.0, 64, dtype=torch.float32)
    _, hi, devs = guard.shadow_check(
        lambda x: torch.complex(torch.zeros_like(x), (x + 1e4) - 1e4), x)
    assert hi.dtype == torch.complex128
    assert devs > 1e-6


def test_shadow_check_structure_matches_jax():
    """devs has the result's structure, one Python float a leaf, as the
    JAX function returns it; the float64 shadow agrees with JAX's."""
    import jax.numpy as jnp
    from ns_tpu.utils.guard import shadow_check as jshadow
    rng = np.random.default_rng(4)
    a = rng.normal(size=(32,)).astype(np.float32)

    def tfn(x):
        return {"s": (x * x).sum(), "c": torch.complex(x, -x) ** 2}

    def jfn(x):
        return {"s": (x * x).sum(), "c": (x - 1j * x) ** 2}

    _, hi, devs = guard.shadow_check(tfn, torch.tensor(a))
    _, jhi, jdevs = jshadow(jfn, jnp.asarray(a))
    assert set(devs) == set(jdevs) and all(
        isinstance(v, float) for v in devs.values())
    np.testing.assert_allclose(hi["s"].numpy(), np.asarray(jhi["s"]),
                               rtol=1e-12)
    np.testing.assert_allclose(hi["c"].numpy(), np.asarray(jhi["c"]),
                               rtol=1e-12, atol=1e-12)
