"""The port's runtime engines (ns_tpu_torch.runtime) against the JAX
package's, on the CPU.

Every engine is held against ns_tpu's AOT engine on the same config and
inputs in float64, <= 1e-10 of the output's max: RolloutEngine on every 2D
engine (fft, padded matmul, compact, real_gemm), FDRolloutEngine on
chorin_fd in its explicit, semi_implicit, dst and helmholtz modes and on
direct_fd (jacobi and exact), and Rollout3DEngine on both 3D engines. The
CPU has no CUDA graph, so the engines run their eager loop here
(`captured` False); the replay is held against that loop bitwise on the
card (tests/test_torch_cuda.py, chip_smoke.py). Exported artifacts equal
the engine (CPU programs: bitwise here), also when loaded in a process
that has not imported `ns_tpu_torch.solvers`. Every FD configuration that
ns_tpu exports (its default `use_pallas*` = False) exports in the port
too, the kernels' operators and the gated loops inside the programs:
each artifact is the port's engine bitwise and within 1e-10 of ns_tpu's
engine; the fused 3D route likewise against the port's eager run and
ns_tpu's plain route.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_tpu.runtime import engine as jrt
from ns_tpu.solvers import chorin_fd as jchorin
from ns_tpu.solvers import direct_fd as jdirect
from ns_tpu.solvers import spectral3d as js3
from ns_tpu.solvers import spectral_periodic as jsp
from ns_tpu_torch import runtime
from ns_tpu_torch.runtime import engine as trt
from ns_tpu_torch.solvers import chorin_fd, direct_fd
from ns_tpu_torch.solvers import spectral3d as s3
from ns_tpu_torch.solvers import spectral_periodic as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(got, want, bound=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound * scale


ENGINES_2D = {
    "fft": {},
    "matmul": dict(transform="matmul", matmul_precision="highest"),
    "compact": dict(transform="matmul", matmul_precision="highest",
                    compact_spectrum=True),
    "real_gemm": dict(transform="matmul", matmul_precision="highest",
                      compact_spectrum=True, real_gemm=True),
}


@pytest.mark.parametrize("engine", list(ENGINES_2D))
def test_rollout_engine_matches_jax(engine):
    kw = dict(nt=6, nx=16, ny=16, dt=5e-3, nu=1e-3, dtype="float64",
              **ENGINES_2D[engine])
    jcfg, cfg = jsp.SpectralPeriodicConfig(**kw), sp.SpectralPeriodicConfig(
        **kw)
    w0 = np.asarray(jsp.decaying_turbulence_vorticity(jcfg, seed=1))
    want = np.asarray(jrt.RolloutEngine(jcfg)(w0))
    eng = runtime.RolloutEngine(cfg, device="cpu")
    assert eng.captured is False and "CPU" in eng.eager_reason
    got = eng(w0)
    assert got.dtype == torch.float64 and got.shape == (16, 16)
    close(got, want)
    # the engine is the system's rollout: its final vorticity, bitwise
    sys_ = sp.NavierStokesSystem(w0, device="cpu", **kw)
    final = sp.physical_from_carry(cfg, sys_.final_state()[0])
    assert torch.equal(got, final)


def _bcs(pkg, nx):
    from ns_tpu.cli.run_solver import cavity_bcs as jbcs
    from ns_tpu_torch.cli.run_solver import cavity_bcs as tbcs

    h = 2.0 / (nx - 1)
    return (jbcs if pkg == "jax" else tbcs)(h, h)


FD_CASES = [
    ("chorin_fd", dict(method="explicit", pressure_mode="redblack")),
    ("chorin_fd", dict(method="semi_implicit", pressure_mode="redblack")),
    ("chorin_fd", dict(method="semi_implicit", pressure_mode="dst")),
    ("chorin_fd", dict(method="helmholtz", pressure_mode="dst")),
    ("direct_fd", dict(pressure_mode="jacobi")),
    ("direct_fd", dict(pressure_mode="exact")),
]


def _fd_configs(family, mode, nx, nt=5):
    kw = dict(nt=nt, nx=nx, ny=nx, dt=1e-3, nu=0.1, **mode)
    if family == "chorin_fd":
        kw.update(nit=60, beta=1.25)
        return jchorin.ChorinFDConfig(**kw), chorin_fd.ChorinFDConfig(**kw)
    kw.update(nit=20)
    return jdirect.DirectFDConfig(**kw), direct_fd.DirectFDConfig(**kw)


def _lid_ics(nx):
    """Initial fields that are not at rest: direct_fd keeps them as they
    are (its reference applies the BCs only after a step), chorin_fd
    applies the BCs to them first."""
    rng = np.random.default_rng(4)
    return [0.1 * rng.standard_normal((nx, nx)) for _ in range(3)]


@pytest.mark.parametrize("family,mode", FD_CASES)
def test_fd_rollout_engine_matches_jax(family, mode):
    nx = 17
    jcfg, cfg = _fd_configs(family, mode, nx)
    ics = _lid_ics(nx)
    want = jrt.FDRolloutEngine(family, jcfg, *_bcs("jax", nx),
                               dtype=jnp.float64)(*ics)
    eng = runtime.FDRolloutEngine(family, cfg, *_bcs("jax", nx),
                                  dtype=torch.float64, device="cpu")
    got = eng(*ics)
    assert len(got) == 3
    for g, w in zip(got, want):
        close(g, w)


def test_fd_engine_init_rules_match_the_systems():
    """chorin_fd applies the BCs to the ICs (AB2 history seeded), direct_fd
    does not: each engine equals its family's NavierStokesSystem bitwise
    on fields that violate the BCs."""
    nx = 17
    ics = _lid_ics(nx)
    bcs = _bcs("torch", nx)
    for family, mod in (("chorin_fd", chorin_fd), ("direct_fd", direct_fd)):
        _, cfg = _fd_configs(family, FD_CASES[0][1] if family == "chorin_fd"
                             else FD_CASES[4][1], nx)
        kw = dict(nt=cfg.nt, nit=cfg.nit, nx=nx, ny=nx, dt=cfg.dt,
                  nu=cfg.nu, dtype=torch.float64, device="cpu")
        if family == "chorin_fd":
            kw["method"] = cfg.method
        want = [a[-1] for a in mod.NavierStokesSystem(*ics, *bcs,
                                                      **kw).simulate()]
        got = runtime.FDRolloutEngine(family, cfg, *bcs, dtype=torch.float64,
                                      device="cpu")(*ics)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("transform", ["fft", "matmul"])
def test_rollout3d_engine_matches_jax(transform):
    kw = dict(nt=3, nx=8, ny=8, nz=8, dt=1e-3, nu=1e-2, dtype="float64",
              transform=transform, matmul_precision="highest")
    jcfg, cfg = js3.Spectral3DConfig(**kw), s3.Spectral3DConfig(**kw)
    u0 = np.asarray(js3.random_solenoidal_velocity(jcfg, seed=0,
                                                   k_peak=1.5))
    want = np.asarray(jrt.Rollout3DEngine(jcfg)(u0))
    eng = runtime.Rollout3DEngine(cfg, device="cpu")
    got = eng(u0)
    assert got.shape == (3, 8, 8, 8)
    close(got, want)
    assert torch.equal(eng.eager(u0), got)


def test_engine_stats_repr_cost_and_validation():
    cfg = sp.SpectralPeriodicConfig(nt=7, nx=16, ny=16, dtype="float64",
                                    transform="matmul",
                                    matmul_precision="highest",
                                    compact_spectrum=True)
    eng = runtime.RolloutEngine(cfg, device="cpu")
    st = eng.stats()
    assert st["captured"] is False and st["nt"] == 7
    assert st["chunk"] == trt.CHUNK
    assert st["engine"] == "RolloutEngine" and st["graphs"] == []
    assert "captured=False" in repr(eng)
    cost = eng.cost_analysis
    # the compact engine's DFT products: 4 GEMMs a transform, counted
    assert cost["flops"] > 0 and "FFT" in cost["flops_note"]
    assert cost["graph_nodes_per_chunk"] is None
    with pytest.raises(ValueError, match="nt"):
        runtime.RolloutEngine(dataclasses.replace(cfg, nt=-1), device="cpu")
    with pytest.raises(ValueError, match="family"):
        runtime.FDRolloutEngine("chorin_spectral", None, [], [], [],
                                device="cpu")


def test_copy_into_handles_carries_that_pass_through():
    """The captured chunk writes its final carry into the static buffers;
    an entry that is another static buffer (chorin_fd's u_prev after one
    step is the carry's u) must be read before it is overwritten."""
    a, b = torch.tensor([1.0]), torch.tensor([2.0])
    new_a = torch.tensor([5.0])
    trt._copy_into((a, b), (new_a, a))   # u <- new u, u_prev <- old u
    assert a.item() == 5.0 and b.item() == 1.0
    trt._copy_into((a, b), (a, b))       # unchanged entries
    assert a.item() == 5.0 and b.item() == 1.0


def test_export_roundtrips(tmp_path):
    """Each artifact equals its engine (the same CPU ops: bitwise)."""
    cfg = sp.SpectralPeriodicConfig(nt=5, nx=16, ny=16, dtype="float64",
                                    transform="matmul",
                                    matmul_precision="highest",
                                    compact_spectrum=True, real_gemm=True)
    w0 = sp.taylor_green_vorticity(cfg)
    path = runtime.export_rollout(cfg, str(tmp_path / "r.pt2z"),
                                  device="cpu")
    got = runtime.load_rollout_artifact(path)(torch.as_tensor(w0))
    assert torch.equal(got, runtime.RolloutEngine(cfg, device="cpu")(w0))

    nx = 17
    _, fcfg = _fd_configs("chorin_fd", dict(method="semi_implicit",
                                            pressure_mode="dst"), nx)
    bcs = _bcs("torch", nx)
    ics = [torch.as_tensor(a) for a in _lid_ics(nx)]
    path = runtime.export_fd_rollout("chorin_fd", fcfg, *bcs,
                                     str(tmp_path / "fd.pt2z"),
                                     dtype=torch.float64, device="cpu")
    got = runtime.load_fd_rollout_artifact(path)(*ics)
    want = runtime.FDRolloutEngine("chorin_fd", fcfg, *bcs,
                                   dtype=torch.float64, device="cpu")(*ics)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="holds"):
        runtime.load_rollout_artifact(path)

    c3 = s3.Spectral3DConfig(nt=2, nx=8, ny=8, nz=8, dtype="float64",
                             transform="matmul", matmul_precision="highest")
    u0 = torch.as_tensor(s3.taylor_green_velocity(c3))
    path = runtime.export_rollout3d(c3, str(tmp_path / "r3.pt2z"),
                                    device="cpu")
    got = runtime.load_rollout3d_artifact(path)(u0)
    assert torch.equal(got, runtime.Rollout3DEngine(c3, device="cpu")(u0))


_LOAD = """
import json, sys
import numpy as np, torch
from ns_tpu_torch.runtime import load_fd_rollout_artifact
ics = [torch.as_tensor(a) for a in np.load(sys.argv[1]).values()]
for art in sys.argv[2:]:
    u, v, p = load_fd_rollout_artifact(art)(*ics)
    np.save(art + ".npy", torch.stack([u, v, p]).numpy())
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("ns_tpu_torch.solvers")
                        or m.split(".")[0] in ("jax", "ns_tpu"))))
"""


def test_artifact_runs_without_the_solvers(tmp_path):
    """FD artifacts (direct_fd exact: mixed-BC eigenbasis GEMMs; chorin_fd
    explicit + redblack: the operators of K3 and K1) loaded in a fresh
    process: no module of ns_tpu_torch.solvers (nor jax) is imported
    there, and each gives its engine's fields bitwise."""
    nx = 16
    bcs = _bcs("torch", nx)
    ics = _lid_ics(nx)
    runs = []
    for family, mode in (("direct_fd", dict(pressure_mode="exact")),
                         FD_EXPORTS[0]):
        _, cfg = _fd_configs(family, mode, nx)
        art = runtime.export_fd_rollout(family, cfg, *bcs,
                                        str(tmp_path / f"{family}.pt2z"),
                                        dtype=torch.float64, device="cpu")
        runs.append((family, cfg, art))
    np.savez(tmp_path / "ics.npz", *ics)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD, str(tmp_path / "ics.npz"),
         *(art for *_, art in runs)], capture_output=True, text=True,
        env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    for family, cfg, art in runs:
        want = runtime.FDRolloutEngine(family, cfg, *bcs,
                                       dtype=torch.float64,
                                       device="cpu")(*ics)
        np.testing.assert_array_equal(np.load(art + ".npy"),
                                      torch.stack(want).numpy())


# every FD configuration ns_tpu exports, by what the port runs for it on
# the card: (family, mode)
FD_EXPORTS = [
    ("chorin_fd", dict(method="explicit", pressure_mode="redblack")),  # K1+K3
    ("chorin_fd", dict(method="semi_implicit", pressure_mode="redblack")),
    ("chorin_fd", dict(method="semi_implicit", pressure_mode="cg")),
    ("chorin_fd", dict(method="semi_implicit",
                       pressure_mode="gauss_seidel")),
    ("chorin_fd", dict(method="explicit", pressure_mode="cg")),
    ("direct_fd", dict(pressure_mode="jacobi")),                       # K2
]


@pytest.mark.parametrize("family,mode", FD_EXPORTS)
def test_fd_exports_match_both_engines(tmp_path, family, mode):
    """An FD configuration that runs a kernel or a gated loop exports: the
    artifact is the port's engine bitwise and within 1e-10 of ns_tpu's
    engine, which ns_tpu also exports."""
    nx = 17
    jcfg, cfg = _fd_configs(family, mode, nx)
    ics = _lid_ics(nx)
    art = runtime.export_fd_rollout(family, cfg, *_bcs("torch", nx),
                                    str(tmp_path / "fd.pt2z"),
                                    dtype=torch.float64, device="cpu")
    got = runtime.load_fd_rollout_artifact(art)(
        *(torch.as_tensor(a) for a in ics))
    eng = runtime.FDRolloutEngine(family, cfg, *_bcs("torch", nx),
                                  dtype=torch.float64, device="cpu")
    want = jrt.FDRolloutEngine(family, jcfg, *_bcs("jax", nx),
                               dtype=jnp.float64)(*ics)
    for g, e, w in zip(got, eng(*ics), want):
        assert g.dtype == torch.float64 and torch.equal(g, e)
        close(g, w)


def test_fused_3d_export_matches_both_engines(tmp_path):
    """The fused route (K6 at the init, K8 every step; their twins here)
    exports: bitwise the port's eager run, and within float32 rounding
    (2e-6 of max|u|) of ns_tpu's plain route at 'highest'."""
    kw = dict(nt=3, nx=16, ny=16, nz=16, dt=1e-3, nu=1e-2,
              transform="matmul", matmul_precision="highest")
    cfg = s3.Spectral3DConfig(use_pallas_transform=True, **kw)
    u0 = s3.taylor_green_velocity(cfg)
    art = runtime.export_rollout3d(cfg, str(tmp_path / "f3.pt2z"),
                                   device="cpu")
    got = runtime.load_rollout3d_artifact(art)(torch.as_tensor(u0))
    assert got.dtype == torch.float32 and got.shape == (3, 16, 16, 16)
    assert torch.equal(got, runtime.Rollout3DEngine(cfg,
                                                    device="cpu").eager(u0))
    want = np.asarray(jrt.Rollout3DEngine(js3.Spectral3DConfig(**kw))(u0))
    close(got, want, bound=2e-6)


def test_runtime_exports_the_jax_names():
    import ns_tpu.runtime as jruntime
    assert sorted(runtime.__all__) == sorted(jruntime.__all__)
    for name in runtime.__all__:
        assert callable(getattr(runtime, name))
