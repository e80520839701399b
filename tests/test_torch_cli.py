"""The whole slice through both CLIs, and the port's no-jax guarantee.

Both packages' run_solver write direct_fd and chorin_fd rollouts (nt=5,
float64; the dst, multigrid, helmholtz and exact modes among them),
taylor_green / decaying_turbulence rollouts (16^2, nt=3, float64; the
compact engine, --n-traj, --forcing fno and --frame-stride/--spinup among
them) and taylor_green_3d / decaying_turbulence_3d rollouts (16^3, nt=3,
float64) on the CPU; the npz files agree <= 1e-9 and the port's FD and 2D
files load in the JAX trainer. A subprocess (this process has imported jax
through the conftest) shows the port's CLI runs without importing jax or
the JAX package, and that the CPU path launches no kernel.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ns_tpu.cli import run_solver as j_cli
from ns_tpu.train.trainer import load_obs
from ns_tpu_torch.cli import run_solver as t_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [
    ["direct_fd"], ["chorin_fd"], ["chorin_fd", "--method", "explicit"],
    ["chorin_fd", "--pressure-mode", "dst"],
    ["chorin_fd", "--method", "helmholtz", "--pressure-mode", "multigrid"],
    ["direct_fd", "--pressure-mode", "exact"],
])
def test_cli_rollouts_match_jax_cli(tmp_path, argv):
    common = ["--nt", "5", "--dtype", "float64"]
    j_out, t_out = tmp_path / "jax.npz", tmp_path / "torch.npz"
    j_cli.main(argv + common + ["--out", str(j_out)])
    summary = t_cli.main(argv + common + ["--device", "cpu", "--out",
                                          str(t_out)])
    assert summary["out"] == str(t_out) and summary["device"] == "cpu"
    j, t = np.load(j_out), np.load(t_out)
    for key in "uvp":
        assert t[key].shape == j[key].shape == (5,) + t[key].shape[1:]
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-9)
    obs = load_obs(str(t_out), None)
    assert obs.shape == (5, 1, 3) + t["u"].shape[1:]


@pytest.mark.parametrize("argv", [
    ["taylor_green_3d"],
    ["decaying_turbulence_3d", "--seed", "3", "--transform", "fft"],
    ["taylor_green_3d", "--frame-stride", "2", "--spinup", "1",
     "--forcing", "kolmogorov", "--forcing-k", "2"],
])
def test_3d_cli_rollouts_match_jax_cli(tmp_path, argv):
    common = ["--nx", "16", "--nt", "3", "--dtype", "float64", "--precision",
              "highest"]
    j_out, t_out = tmp_path / "jax.npz", tmp_path / "torch.npz"
    j_cli.main(argv + common + ["--out", str(j_out)])
    summary = t_cli.main(argv + common + ["--device", "cpu", "--out",
                                          str(t_out)])
    assert summary["use_pallas_transform"] is False
    j, t = np.load(j_out), np.load(t_out)
    assert sorted(t.files) == sorted(j.files) == ["p", "u", "v", "w"]
    for key in "uvwp":
        assert t[key].shape == j[key].shape == (3, 16, 16, 16)
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-9)


@pytest.mark.parametrize("argv,name,shape", [
    (["taylor_green"], "taylor_green.npz", (3, 16, 16)),
    (["decaying_turbulence", "--transform", "matmul", "--compact", "--seed",
      "2"],
     "decaying_turbulence.npz", (3, 16, 16)),
    (["decaying_turbulence", "--transform", "fft", "--forcing", "fno",
      "--forcing-k", "2"], "decaying_turbulence.npz", (3, 16, 16)),
    (["taylor_green", "--transform", "matmul", "--frame-stride", "2",
      "--spinup", "1", "--forcing", "kolmogorov", "--forcing-k", "2"],
     "taylor_green.npz", (3, 16, 16)),
    (["decaying_turbulence", "--n-traj", "2", "--seed", "3", "--transform",
      "matmul", "--compact"],
     "decaying_turbulence_x2.npz", (2, 3, 16, 16)),
    (["decaying_turbulence", "--n-traj", "2", "--frame-stride", "2",
      "--transform", "fft"], "decaying_turbulence_x2.npz", (2, 3, 16, 16)),
])
def test_2d_cli_rollouts_match_jax_cli(tmp_path, monkeypatch, argv, name,
                                       shape):
    """The 2D periodic families, written under the reference file names
    ({family}.npz, {family}_x{N}.npz) in the working directory. Engine for
    engine: where 'auto' differs (ROADMAP.md §3) the case names the JAX
    package's engine, since compact truncates decaying turbulence's initial
    field to the dealiased band and fft does not."""
    common = ["--nx", "16", "--nt", "3", "--dtype", "float64", "--precision",
              "highest"]
    got = {}
    for pkg, main in (("jax", j_cli.main), ("torch", t_cli.main)):
        run_dir = tmp_path / pkg
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        main(argv + common + (["--device", "cpu"] if pkg == "torch" else []))
        got[pkg] = np.load(run_dir / name)
    j, t = got["jax"], got["torch"]
    assert sorted(t.files) == sorted(j.files) == ["p", "u", "v"]
    for key in "uvp":
        assert t[key].shape == j[key].shape == shape
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-9)
    if len(shape) == 3:
        obs = load_obs(str(tmp_path / "torch" / name), None)
        assert obs.shape == (3, 1, 3, 16, 16)


@pytest.mark.parametrize("argv", [
    ["taylor_green_3d", "--forcing", "fno"],
    ["taylor_green_3d", "--compact"],
    ["decaying_turbulence_3d", "--n-traj", "2"],
    ["taylor_green_3d", "--guard"],
    ["taylor_green_3d", "--frame-stride", "0"],
    ["direct_fd", "--forcing", "kolmogorov"],
    ["chorin_fd", "--spinup", "2"],
    ["taylor_green_3d", "--pallas-momentum"],
    ["taylor_green", "--n-traj", "2"],
    ["decaying_turbulence", "--n-traj", "0"],
    ["decaying_turbulence", "--n-traj", "2", "--guard"],
    ["taylor_green", "--frame-stride", "2", "--stream-dir", "x"],
    ["decaying_turbulence", "--spinup", "-1"],
    ["taylor_green", "--forcing", "sinusoid"],
])
def test_cli_rejects_what_the_jax_cli_rejects(argv):
    for main in (j_cli.main, t_cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--nt", "1", "--nx", "8"])
        assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    ["taylor_green", "--transform", "fft"],
    ["chorin_spectral", "--corrected", "--guard"],
    ["chorin_fd", "--method", "explicit", "--progress"],
])
def test_cli_stream_dir_as_the_jax_cli(tmp_path, capsys, argv):
    """--stream-dir (ported; these cases once checked its "not yet ported"
    error) streams each family as the JAX CLI does: the same .npy files
    (u/v/p, u/v/p/w for the periodic families; float64 rollouts stored as
    float32: within one float32 rounding or the npz runs' 1e-9), the
    same note where the JAX CLI ignores a flag under streaming, and no
    npz."""
    nx = 16 if argv[0] == "taylor_green" else 17
    common = ["--nt", "3", "--nx", str(nx), "--dtype", "float64"]
    notes = {}
    for pkg, main, extra in (("jax", j_cli.main, []),
                             ("torch", t_cli.main, ["--device", "cpu"])):
        out = tmp_path / pkg
        main(argv + common + extra + ["--stream-dir", str(out),
                                      "--out", str(tmp_path / f"{pkg}.npz")])
        notes[pkg] = [line for line in capsys.readouterr().out.splitlines()
                      if line.startswith("note:")]
        assert not (tmp_path / f"{pkg}.npz").exists()
    assert notes["torch"] == notes["jax"]
    assert (len(notes["jax"]) == 1) == ("--guard" in argv)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    assert names == (["p.npy", "u.npy", "v.npy", "w.npy"]
                     if argv[0] == "taylor_green"
                     else ["p.npy", "u.npy", "v.npy"])
    for name in names:
        j, t = (np.load(tmp_path / pkg / name) for pkg in ("jax", "torch"))
        assert t.shape == j.shape == (3, nx, nx) and t.dtype == np.float32
        np.testing.assert_allclose(t, j, rtol=2.0**-23, atol=1e-9)


@pytest.mark.parametrize("argv", [
    ["chorin_spectral", "--dist"],
    ["chorin_fd", "--dist"],
    ["taylor_green", "--dist"],
    ["direct_fd", "--pressure-mode", "cg"],
    ["direct_fd", "--pallas-momentum"],
    ["chorin_fd", "--pallas-momentum"],
])
def test_cli_rejects_what_is_not_ported(argv, capsys, monkeypatch):
    """Flag combinations the CLI refuses before any compute: --dist for
    the cavity families (the JAX CLI's text), --dist outside a launched
    process group, and the JAX CLI's other flag rules."""
    for var in ("NS_TPU_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as e:
        t_cli.main(argv + ["--device", "cpu", "--nt", "1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    if argv[0] == "taylor_green":
        assert "python -m ns_tpu_torch.launch" in err
    elif "--dist" in argv:
        assert "--dist currently supports the periodic families" in err


_NO_JAX = """
import json, sys
import ns_tpu_torch
from ns_tpu_torch.cli import run_solver
from ns_tpu_torch.ops import kernels
run_solver.main(["chorin_fd", "--method", "explicit", "--nt", "2",
                 "--nx", "17", "--device", "cpu", "--out", sys.argv[1]])
run_solver.main(["direct_fd", "--nt", "2", "--nx", "17", "--device", "cpu",
                 "--out", sys.argv[1]])
run_solver.main(["taylor_green_3d", "--nt", "2", "--nx", "16", "--device",
                 "cpu", "--transform", "matmul", "--pallas-transform", "on",
                 "--out", sys.argv[1]])
print(json.dumps({"jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "ns_tpu")),
                  "launches": kernels.launch_counts()}))
"""


def test_port_cli_runs_without_jax_and_launches_nothing_on_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp_path / "o.npz")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax"] == []
    assert set(report["launches"]) == {
        "sor_redblack_fused", "jacobi_fused", "jacobi_multiblock",
        "momentum_explicit_fused", "sor_redblack_packed_multiblock",
        "sor_redblack_multiblock",
        "fused_zy_forward", "fused_yz_inverse", "fused_lamb"}
    assert set(report["launches"].values()) == {0}


def test_no_card_needs_device_cpu(monkeypatch, capsys):
    """Repair: with no CUDA device, run_solver used to fall back to the CPU
    and the systems built on torch's default device. Now the CLI (default
    --device cuda) exits with an error that names --device cpu, the solver
    systems and the 3D helpers given host data raise with device=None, and
    an explicit CPU request runs as before."""
    import torch

    from ns_tpu_torch.solvers import chorin_fd, direct_fd
    from ns_tpu_torch.solvers import spectral3d as t3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["chorin_fd"], ["direct_fd", "--nt", "2"],
                 ["taylor_green_3d", "--nx", "8"],
                 ["decaying_turbulence", "--nx", "8", "--compact"]):
        with pytest.raises(SystemExit) as e:
            t_cli.build(argv)
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err
    args, device, _ = t_cli.build(["chorin_fd", "--nt", "2", "--nx", "9",
                                   "--device", "cpu"])
    assert device.type == "cpu"
    nx = 9
    bcs = t_cli.cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    z = np.zeros((nx, nx))
    kw = dict(nt=1, nit=5, nx=nx, ny=nx)
    cfg = t3.Spectral3DConfig(nx=8, ny=8, nz=8)
    u0 = t3.taylor_green_velocity(cfg)
    for build in (lambda d: direct_fd.NavierStokesSystem(z, z, z, *bcs,
                                                         device=d, **kw),
                  lambda d: chorin_fd.NavierStokesSystem(z, z, z, *bcs,
                                                         device=d, **kw),
                  lambda d: t3.NavierStokesSystem3D(u0, nt=1, nx=8, ny=8,
                                                    nz=8, device=d),
                  lambda d: t3.init_from_velocity(cfg, u0, d),
                  lambda d: t3.simulate_strided(cfg, u0, 1, device=d)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(None)
        with pytest.raises(RuntimeError, match="--device cpu"):
            build("cuda")
        build("cpu")
    # a tensor given without a device stays where it is
    carry = t3.init_from_velocity(cfg, torch.as_tensor(u0))
    assert carry[0].device.type == "cpu"


def _run_both(tmp_path, capsys, argv):
    """Both CLIs on argv (float64, --out in tmp_path): their npz and the
    guard/note lines each printed."""
    got = {}
    for pkg, main in (("jax", j_cli.main), ("torch", t_cli.main)):
        out = tmp_path / f"{pkg}.npz"
        extra = ["--device", "cpu"] if pkg == "torch" else []
        main(argv + ["--dtype", "float64", "--out", str(out)] + extra)
        said = [line for line in capsys.readouterr().out.splitlines()
                if line.startswith(("guard:", "note:"))]
        got[pkg] = (np.load(out), said)
    return got["jax"], got["torch"]


@pytest.mark.parametrize("argv", [
    ["chorin_spectral", "--corrected", "--nt", "5"],
    ["chorin_spectral", "--corrected", "--nt", "5", "--nx", "25",
     "--dt", "1e-4", "--gemm-precision", "high"],
    ["chorin_spectral", "--corrected", "--nt", "5", "--guard"],
    ["chorin_spectral", "--corrected", "--nt", "5", "--progress",
     "--chunk", "2"],
    ["chorin_spectral", "--nt", "6", "--guard"],
    ["chorin_spectral", "--nt", "6", "--guard", "--progress"],
    ["chorin_spectral", "--corrected", "--nt", "4", "--guard",
     "--guard-max-abs", "1000"],
    ["chorin_spectral", "--corrected", "--nt", "4", "--guard",
     "--guard-max-abs", "30"],
    ["direct_fd", "--nt", "5", "--nx", "17", "--guard"],
    ["chorin_fd", "--nt", "5", "--nx", "17", "--progress", "--chunk", "2"],
    ["chorin_fd", "--method", "explicit", "--nt", "12", "--nx", "17",
     "--dt", "0.2", "--guard"],
    ["taylor_green", "--nt", "3", "--nx", "16", "--progress", "--chunk",
     "2", "--precision", "highest"],
    ["decaying_turbulence", "--nt", "3", "--nx", "16", "--guard",
     "--transform", "fft"],
    ["taylor_green", "--nt", "3", "--nx", "16", "--guard", "--progress",
     "--precision", "highest"],
])
def test_guard_progress_and_chebyshev_cli_match_jax_cli(tmp_path, capsys,
                                                        argv):
    """The chorin_spectral preset, --corrected, --guard (a trip, its step
    and the frozen frames; no trip), --guard-max-abs, --progress/--chunk
    and the notes the JAX CLI prints for flag mixes it ignores: npz <= 1e-9
    (float64) and the same guard/note lines."""
    (j, j_said), (t, t_said) = _run_both(tmp_path, capsys, argv)
    assert t_said == j_said
    if "--guard" in argv and argv[0] == "chorin_spectral" and (
            "--corrected" not in argv or "30" in argv):
        # the quirk preset's fields reach ~1e11 in its first step, and the
        # corrected one's pressure 661 > 30
        assert t_said[-1].startswith("guard: divergence at step 0")
    if "0.2" in argv:
        assert t_said and "divergence at step" in t_said[0]
    for key in "uvp":
        assert t[key].shape == j[key].shape
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-9)


def test_quirk_cli_step_zero_matches_jax_cli(tmp_path, capsys):
    """The reference preset unguarded, one step: p to 1e-11 of its max,
    u and v to 1e-7 of the cancellation scale dt*|p| (the JAX golden
    test's bounds)."""
    (j, _), (t, _) = _run_both(tmp_path, capsys, ["chorin_spectral",
                                                  "--nt", "1"])
    p_scale = np.abs(j["p"][0]).max()
    assert np.abs(t["p"][0] - j["p"][0]).max() <= 1e-11 * p_scale
    for key in "uv":
        assert np.abs(t[key][0] - j[key][0]).max() <= 1e-7 * 1e-3 * p_scale


@pytest.mark.parametrize("argv", [
    ["taylor_green_3d", "--progress"],
    ["decaying_turbulence_3d", "--guard"],
    ["taylor_green", "--frame-stride", "2", "--progress"],
    ["taylor_green", "--spinup", "1", "--guard"],
    ["decaying_turbulence", "--n-traj", "2", "--progress"],
    ["chorin_spectral", "--frame-stride", "2"],
    ["chorin_spectral", "--forcing", "kolmogorov"],
    ["chorin_spectral", "--pallas-momentum"],
])
def test_cli_rejects_guard_progress_misuse_alike(argv):
    for main in (j_cli.main, t_cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--nt", "1", "--nx", "9"])
        assert e.value.code == 2


def test_progress_chunk_zero_raises_alike(tmp_path):
    argv = ["chorin_spectral", "--corrected", "--nt", "2", "--nx", "9",
            "--progress", "--chunk", "0", "--out", str(tmp_path / "o.npz")]
    for main, extra in ((j_cli.main, []), (t_cli.main, ["--device",
                                                        "cpu"])):
        with pytest.raises(ValueError, match="chunk must be >= 1"):
            main(argv + extra)


@pytest.mark.parametrize("n", [33, 51])
def test_sanity_cli_prints_what_the_jax_cli_prints(capsys, n):
    from ns_tpu.cli import sanity as j_sanity
    from ns_tpu_torch.cli import sanity as t_sanity

    j_sanity.main(["--n", str(n)])
    want = capsys.readouterr().out
    t_sanity.main(["--n", str(n)])
    got = capsys.readouterr().out
    assert got == want and got.splitlines()[-1] == "sanity: all checks passed"


_NO_JAX_CHEB = """
import json, sys
from ns_tpu_torch.cli import run_solver, sanity
run_solver.main(["chorin_spectral", "--nt", "3", "--nx", "17", "--device",
                 "cpu", "--guard", "--out", sys.argv[1]])
run_solver.main(["chorin_spectral", "--corrected", "--nt", "3", "--nx",
                 "17", "--device", "cpu", "--progress", "--chunk", "2",
                 "--out", sys.argv[1]])
sanity.main(["--n", "17"])
print(json.dumps({"jax": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "ns_tpu"))}))
"""


def test_chebyshev_guard_progress_sanity_run_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_CHEB, str(tmp_path / "o.npz")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1])["jax"] == []
    assert "guard: divergence at step 0" in proc.stdout


def test_chorin_spectral_needs_a_card_or_device_cpu(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        t_cli.build(["chorin_spectral", "--nt", "2"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    args, device, sys_ = t_cli.build(["chorin_spectral", "--nt", "2",
                                      "--nx", "9", "--device", "cpu"])
    assert device.type == "cpu" and sys_.state0.u.device.type == "cpu"
