"""The port's launcher (`python -m ns_tpu_torch.launch`), its self-test and
run_solver --dist, as subprocesses on the CPU (gloo).

The counterparts of tests/test_multiprocess.py's launcher cases (:24, :42,
:64, :179, :192): the self-test on two ranks, run_solver --dist on two
ranks (shard files and the assembled npz, held against the JAX package's
sharded simulate within 1e-10 and its CLI's u, v), a failing, a
signal-killed and a late-crashing worker while an early one blocks. Plus
the port's refusals: several devices a process, a CUDA gang without a
card, and run_solver's --dist flag rules.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "ns_tpu_torch.launch"]


def _env(env=None):
    full = dict(os.environ)
    full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
    full.update(env or {})
    return full


def run(args, timeout=120, env=None, cwd=REPO):
    return subprocess.run(args, capture_output=True, text=True,
                          timeout=timeout, cwd=cwd, env=_env(env))


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The file's two gangs of two gloo ranks, run at the same time: the
    self-test, and run_solver --dist through the launcher."""
    out = tmp_path_factory.mktemp("launch")
    cmds = {
        "selftest": (LAUNCH + ["--nprocs", "2", "--platform", "cpu",
                               "--selftest", "--timeout", "100"],
                     {"NS_TPU_SELFTEST_DIR": str(out / "selftest")}),
        "dist": (LAUNCH + ["--nprocs", "2", "--platform", "cpu",
                           "--timeout", "100", "--", sys.executable, "-m",
                           "ns_tpu_torch.cli.run_solver",
                           "decaying_turbulence", "--dist", "--nx", "32",
                           "--nt", "5", "--compact", "--transform", "matmul",
                           "--dtype", "float64", "--device", "cpu", "--out",
                           str(out / "turb.npz")], None)}
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=REPO,
                                 env=_env(env))
             for k, (cmd, env) in cmds.items()}
    results = {}
    for k, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        results[k] = subprocess.CompletedProcess(cmds[k][0], p.returncode,
                                                 stdout, stderr)
    return out, results


def test_launch_selftest_two_processes(gangs):
    """Two ranks: halo exchange, the distributed matmul-DFT rollout
    against a single-device one, all-reduce, per-rank shard IO, across a
    real process boundary."""
    out, results = gangs
    r = results["selftest"]
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SELFTEST OK p0" in r.stdout
    assert "SELFTEST OK p1" in r.stdout
    files = sorted(p.name for p in (out / "selftest").glob(
        "w_final.proc*.npz"))
    assert files == ["w_final.proc0000.npz", "w_final.proc0001.npz"]


def jax_dist_reference(nx, nt):
    """The JAX --dist CLI's fields (its sharded compact simulate, 'uvp', on
    a 2-device mesh) and its plain CLI's, for decaying_turbulence."""
    import jax
    from ns_tpu.parallel import make_mesh as jmesh
    from ns_tpu.parallel.spectral_sharded import (
        make_sharded_compact_simulate)
    from ns_tpu.solvers import spectral_periodic as jsp
    cfg = jsp.SpectralPeriodicConfig(nt=nt, nx=nx, ny=nx, dt=0.001, nu=0.1,
                                     rho=1.0, dtype="float64",
                                     transform="matmul",
                                     matmul_precision="high",
                                     compact_spectrum=True)
    w0 = np.asarray(jsp.decaying_turbulence_vorticity(cfg, seed=0))
    sim, sharding = make_sharded_compact_simulate(
        cfg, jmesh({"x": 2}, devices=jax.devices()[:2]), fields="uvp")
    return [np.asarray(a) for a in sim(jax.device_put(w0, sharding))]


def test_distributed_run_solver_cli(gangs, tmp_path):
    """launcher -> run_solver --dist -> per-rank shard files ->
    coordinator-assembled reference npz, equal to the JAX --dist
    computation within 1e-10 (u and v also to the JAX CLI's plain run)."""
    from ns_tpu.cli.run_solver import main as jax_main
    outdir, results = gangs
    out = str(outdir / "turb.npz")
    r = results["dist"]
    assert r.returncode == 0, r.stdout + r.stderr
    assert "p0/2: decaying_turbulence nt=5 grid=32x32 on 2 devices" \
        in r.stdout
    shards = sorted(p.name for p in (outdir / "turb.npz.shards").iterdir())
    assert shards == [f"{f}.proc{i:04d}.npz" for f in "puv"
                      for i in range(2)]
    d = np.load(out)
    assert d["u"].shape == (5, 32, 32)
    assert np.isfinite(d["u"]).all() and np.abs(d["u"]).max() > 0
    for name, want in zip("uvp", jax_dist_reference(32, 5)):
        assert np.abs(d[name] - want).max() <= 1e-10, name
    jax_out = str(tmp_path / "jax.npz")
    jax_main(["decaying_turbulence", "--nx", "32", "--nt", "5", "--compact",
              "--transform", "matmul", "--dtype", "float64", "--out",
              jax_out])
    j = np.load(jax_out)
    for name in "uv":
        assert np.abs(d[name] - j[name]).max() <= 1e-10, name


def test_no_assemble_and_fft_engine_write_w_shards(tmp_path, monkeypatch):
    """--no-assemble leaves only the shard files; a non-compact engine
    writes the vorticity w. In this process, on a gloo group of one rank
    that the bootstrap variables describe (what the launcher sets)."""
    from ns_tpu_torch.cli import run_solver
    from ns_tpu_torch.parallel import distributed as dist
    monkeypatch.setenv("NS_TPU_COORDINATOR", "file://" + str(tmp_path / "i"))
    monkeypatch.setenv("NS_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("NS_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("NS_TPU_PLATFORM", "cpu")
    out = str(tmp_path / "tg.npz")
    try:
        summary = run_solver.main(["taylor_green", "--dist", "--nx", "16",
                                   "--nt", "3", "--no-assemble", "--out",
                                   out])
    finally:
        dist.shutdown()
    assert summary["out"] is None and summary["processes"] == 1
    assert not os.path.exists(out)
    assert sorted(os.listdir(out + ".shards")) == ["w.proc0000.npz"]


def test_run_solver_dist_flag_rules(capsys):
    from ns_tpu_torch.cli import run_solver
    with pytest.raises(SystemExit):
        run_solver.main(["chorin_fd", "--dist"])
    assert "--dist currently supports the periodic families" in \
        capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_solver.main(["taylor_green", "--dist", "--stream-dir", "x"])
    assert "--stream-dir is not supported with --dist" in \
        capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_solver.main(["decaying_turbulence", "--dist", "--n-traj", "2"])
    assert "--n-traj is not supported with --dist" in \
        capsys.readouterr().err


def test_launch_propagates_worker_failure():
    r = run(LAUNCH + ["--nprocs", "2", "--platform", "cpu", "--",
                      sys.executable, "-c", "import sys; sys.exit(3)"])
    assert r.returncode == 3
    assert "FAILED" in r.stderr


def test_launch_reports_signal_killed_worker():
    """A worker killed by a signal (a negative return code) fails the
    launch."""
    r = run(LAUNCH + ["--nprocs", "2", "--platform", "cpu", "--",
                      sys.executable, "-c",
                      "import os, signal; os.kill(os.getpid(), "
                      "signal.SIGKILL)"])
    assert r.returncode != 0
    assert "FAILED" in r.stderr


def test_launch_detects_late_worker_crash_while_early_worker_blocks():
    """The launcher polls every child: worker 1's crash ends the gang at
    once, though worker 0 sleeps."""
    prog = ("import os, sys, time\n"
            "pid = int(os.environ['NS_TPU_PROCESS_ID'])\n"
            "assert os.environ['RANK'] == str(pid)\n"
            "assert os.environ['WORLD_SIZE'] == '2'\n"
            "if pid == 1:\n"
            "    sys.exit(5)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    r = run(LAUNCH + ["--nprocs", "2", "--platform", "cpu", "--",
                      sys.executable, "-c", prog])
    assert r.returncode == 5, r.stdout + r.stderr
    assert time.monotonic() - t0 < 45


def test_launch_streams_prefixed_output_and_times_out():
    r = run(LAUNCH + ["--nprocs", "2", "--platform", "cpu", "--",
                      sys.executable, "-c",
                      "import os; print('hello', os.environ['LOCAL_RANK'])"])
    assert r.returncode == 0
    assert "[p0] hello 0" in r.stdout and "[p1] hello 1" in r.stdout
    r = run(LAUNCH + ["--nprocs", "1", "--platform", "cpu", "--timeout",
                      "1", "--", sys.executable, "-c",
                      "import time; time.sleep(30)"])
    assert r.returncode == 124


def test_launch_refuses_what_a_torch_rank_cannot_do():
    r = run(LAUNCH + ["--nprocs", "2", "--devices-per-proc", "2",
                      "--platform", "cpu", "--selftest"])
    assert r.returncode == 2
    assert "a torch rank owns one device" in r.stderr
    if not torch.cuda.is_available():
        r = run(LAUNCH + ["--nprocs", "1", "--selftest"])
        assert r.returncode == 2
        assert "no CUDA device is available" in r.stderr
    r = run(LAUNCH + ["--nprocs", "1", "--platform", "cpu"])
    assert r.returncode == 2 and "no worker command" in r.stderr
