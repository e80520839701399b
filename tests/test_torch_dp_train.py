"""Data-parallel training (TrainConfig.dp), the sharded EnsembleTrainer
(`ensemble_mesh`) and cli.train --dist/--dp/--mesh on CPU gangs, against
the port's and the JAX package's single-device trainers.

Two gangs, started at once by the module fixture:
  - a gang of 2 ranks spawned by this file (gloo): fno with an uneven
    window count (9 windows: shares of 5 and 4), fno_w with
    fno_rollout_steps=2 (7 windows), rnn sharding 3 trajectories,
    minibatch sampling with input noise, a resume (2 + 2 iterations
    against 4), one iteration's collective counts, the errors, and an
    ensemble of 2 fno members over ensemble_mesh(2);
  - `python -m ns_tpu_torch.launch --nprocs 4 --platform cpu` of
    cli.train --dist --dp 4 on the 9 windows (shares 3, 2, 2, 2).
Every rank asserts that neither jax nor ns_tpu was imported.

The fno runs start from one JAX Trainer's initial checkpoint, so the JAX
Trainer's own dp-1 losses compare with the port's: rtol 1e-5, the
cross-package bound of tests/test_torch_train_resume.py (the JAX suite
holds its own dp run to rtol 1e-4, tests/test_trainer.py:447). dp against
the port's dp 1 is held to the same bound: the shares' partial sums of
squares and the gradients add in another order. Runs that draw windows
and noise keep the dp-1 generator state bitwise (every rank draws the
whole batch); a resume at dp 2 is bitwise; the ensemble's members equal
the single-device EnsembleTrainer's bitwise.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ns_tpu_torch.parallel import distributed as dist
from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
from ns_tpu_torch.parallel.mesh import axis_sizes
from ns_tpu_torch.train import ensemble as tens
from ns_tpu_torch.train import trainer as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT = 120
ITERS = 4
FNO = dict(fno_modes=3, fno_width=6)


def write_data(folder):
    """fields.npz: 10 frames of 8^2 (u, v, p); multi.npz: 3 trajectories
    of 6 frames."""
    rng = np.random.default_rng(7)
    np.savez(os.path.join(folder, "fields.npz"),
             **{k: rng.normal(size=(10, 8, 8)) for k in "uvp"})
    np.savez(os.path.join(folder, "multi.npz"),
             **{k: rng.normal(size=(3, 6, 8, 8)) for k in "uvp"})


def cases(data: str, j0: str) -> dict:
    """scenario -> TrainConfig keywords (without out_dir and dp)."""
    fields = os.path.join(data, "fields.npz")
    base = dict(npz_path=fields, n_iters=ITERS, ckpt_every=2, n_frames=10)
    return {
        "fno": dict(base, model="fno", resume=j0, **FNO),
        "fno_w_k2": dict(base, model="fno_w", n_frames=9,
                         fno_rollout_steps=2, **FNO),
        "rnn": dict(base, model="rnn", hidden_dim=16, n_frames=6,
                    npz_path=os.path.join(data, "multi.npz")),
        "batch": dict(base, model="fno", batch_size=5, input_noise=0.05,
                      **FNO),
    }


def _cfg(kw, out, **extra):
    return ttr.TrainConfig(**{**kw, "out_dir": out, **extra})


# ---------------------------------------------------------------------------
# the ranks of the gang of 2
# ---------------------------------------------------------------------------

def _counts(kw, out, world):
    tr = ttr.Trainer(_cfg(kw, out, dp=world), device="cpu")
    reset_counts()
    tr.train_chunk(1)
    return dict(COUNTS)


def _errors(kw, out, world):
    msgs = {}
    for name, extra in (("dp_over_world", dict(dp=world + 2)),
                        ("basis", dict(model="basis_ode", dp=world))):
        try:
            ttr.Trainer(_cfg(kw, out, **extra), device="cpu")
            msgs[name] = "no error"
        except ValueError as e:
            msgs[name] = str(e)
    try:
        ttr.make_dp_mesh(_cfg(kw, out, dp=1))
        msgs["dp_under_world"] = "no error"
    except ValueError as e:
        msgs["dp_under_world"] = str(e)
    return msgs


def _ensemble(kw, out):
    sizes = [None if m is None else axis_sizes(m)
             for m in (tens.ensemble_mesh(n) for n in (2, 3, 4))]
    tr = tens.EnsembleTrainer(_cfg(kw, out), 2, mesh="auto", device="cpu")
    return {"meshes": sizes, "share": list(tr._share),
            "losses": tr.train(progress=False)}


def _gang_worker(rank, world, init, out, data, j0):
    assert "jax" not in sys.modules
    torch.set_num_threads(1)
    dist.initialize(init, world, rank, "cpu")
    res = {}
    c = cases(data, j0)
    for name, kw in c.items():
        tr = ttr.Trainer(_cfg(kw, os.path.join(out, name), dp=world),
                         device="cpu")
        res[name] = tr.train(progress=False)
    # resume at dp 2: 2 iterations, then 2 more from that checkpoint
    half = _cfg(c["batch"], os.path.join(out, "half"), dp=world, n_iters=2)
    ttr.Trainer(half, device="cpu").train(progress=False)
    res["resumed"] = ttr.Trainer(_cfg(
        c["batch"], os.path.join(out, "resumed"), dp=world,
        resume=os.path.join(out, "half", "checkpoint.npz")),
        device="cpu").train(progress=False)
    res["counts"] = _counts(c["fno"], os.path.join(out, "counts"), world)
    res["errors"] = _errors(c["fno"], os.path.join(out, "errors"), world)
    ens_kw = {k: v for k, v in c["fno"].items() if k != "resume"}
    res["ensemble"] = _ensemble(ens_kw, os.path.join(out, "ens"))
    with open(os.path.join(out, f"results.{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()
    assert "jax" not in sys.modules
    assert not any(m.split(".")[0] == "ns_tpu" for m in sys.modules)


# cli.train under the launcher, asserting afterwards that the rank
# imported neither jax nor ns_tpu
_CLI = """
import sys
from ns_tpu_torch.cli import train
train.main(sys.argv[1:])
assert "jax" not in sys.modules
assert not any(m.split(".")[0] == "ns_tpu" for m in sys.modules)
"""


def _launch_cli(out, data, j0, nprocs):
    kw = cases(data, j0)["fno"]
    argv = ["--model", "fno", "--npz-path", kw["npz_path"], "--n-frames",
            "10", "--n-iters", str(ITERS), "--ckpt-every", "2",
            "--fno-modes", "3", "--fno-width", "6", "--resume", j0,
            "--dist", "--dp", str(nprocs), "--device", "cpu",
            "--out-dir", os.path.join(out, "cli")]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "ns_tpu_torch.launch", "--nprocs",
         str(nprocs), "--platform", "cpu", "--timeout",
         str(GANG_TIMEOUT - 10), "--", sys.executable, "-c", _CLI] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=out)


class Gangs:
    """The spawned gang of 2 and the launched gang of 4, started at once;
    a test that asks for one waits for it then."""

    def __init__(self, tmp):
        self.data = str(tmp / "data")
        os.makedirs(self.data)
        write_data(self.data)
        self.j0 = self._jax_initial_checkpoint(str(tmp / "j0"))
        self.out2, self.out4 = str(tmp / "gang2"), str(tmp / "gang4")
        os.makedirs(self.out2)
        os.makedirs(self.out4)
        self.ctx = torch.multiprocessing.start_processes(
            _gang_worker, args=(2, "file://" + os.path.join(self.out2,
                                                            "init"),
                                self.out2, self.data, self.j0),
            nprocs=2, join=False, start_method="spawn")
        self.cli = _launch_cli(self.out4, self.data, self.j0, 4)
        self.deadline = time.monotonic() + GANG_TIMEOUT
        self._two = self._four = None

    def _jax_initial_checkpoint(self, out):
        """The JAX Trainer's iteration-0 fno checkpoint (x64 off)."""
        import jax
        from ns_tpu.train import trainer as jtr
        kw = cases(self.data, None)["fno"]
        kw.pop("resume")
        with jax.enable_x64(False):
            jtr.Trainer(jtr.TrainConfig(out_dir=out, **kw)).save(0)
        return os.path.join(out, "checkpoint.npz")

    @property
    def two(self):
        if self._two is None:
            while not self.ctx.join(timeout=1):
                if time.monotonic() > self.deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    raise TimeoutError("the gang of 2 did not finish")
            self._two = [json.load(open(os.path.join(
                self.out2, f"results.{r}.json"))) for r in range(2)]
        return self._two

    @property
    def four(self) -> str:
        """The launched cli.train's output folder (after checking it
        ran)."""
        if self._four is None:
            left = max(1.0, self.deadline - time.monotonic())
            stdout, _ = self.cli.communicate(timeout=left)
            assert self.cli.returncode == 0, stdout[-3000:]
            self._four = os.path.join(self.out4, "cli_10")
        return self._four


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    g = Gangs(tmp_path_factory.mktemp("dp"))
    yield g
    g.two
    if g.cli.poll() is None:
        g.cli.kill()
        g.cli.communicate()


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def port_run(kw, out, **extra):
    """The port's single-device Trainer: (losses, checkpoint path)."""
    tr = ttr.Trainer(_cfg(kw, out, **extra), device="cpu")
    return tr.train(progress=False), os.path.join(out, "checkpoint.npz")


def jax_losses(kw, out):
    import jax
    from ns_tpu.train import trainer as jtr
    with jax.enable_x64(False):
        return [float(x) for x in jtr.Trainer(jtr.TrainConfig(
            out_dir=out, **kw)).train(progress=False)]


def arrays(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def meta(path):
    with open(path + ".meta.json") as f:
        return json.load(f)


def assert_params_close(got, want, lr=1e-3):
    """tests/test_torch_train_resume.py's parameter bound: 1e-5 outside
    the first spectral layer, where Adam turns rounding in a zero
    gradient into up to a step, and a root-mean-square difference of at
    most lr / 10 over every parameter."""
    keys = sorted(k for k in want if k.startswith("params/"))
    assert keys and keys == sorted(k for k in got if k.startswith("params/"))
    diffs = {k: np.abs(got[k] - want[k]) for k in keys}
    assert max(d.max() for k, d in diffs.items()
               if not k.startswith("params/spectral/0/")) <= 1e-5
    flat = np.concatenate([d.ravel() for d in diffs.values()])
    assert np.sqrt(np.mean(flat ** 2)) <= lr / 10


def rclose(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_batch_share_splits_like_array_split():
    for n in range(0, 12):
        for size in (1, 2, 3, 4):
            want = [len(a) for a in np.array_split(np.arange(n), size)]
            got = [np.subtract(*ttr.batch_share(n, i, size)[::-1])
                   for i in range(size)]
            assert got == want
            assert ttr.batch_share(n, size - 1, size)[1] == n


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_fno_uneven_windows_match_dp_1(gangs, tmp_path, dp):
    """9 windows over 2 ranks (5, 4) and over 4 (3, 2, 2, 2, through
    cli.train --dist under the launcher) against the port's and the JAX
    Trainer's dp-1 runs from the same initial checkpoint."""
    kw = cases(gangs.data, gangs.j0)["fno"]
    ref, ref_ckpt = port_run(kw, str(tmp_path / "one"))
    jl = jax_losses(kw, str(tmp_path / "jax"))
    rclose(ref, jl)
    if dp == 2:
        for r in range(2):
            rclose(gangs.two[r]["fno"], ref)
        assert gangs.two[0]["fno"] == gangs.two[1]["fno"]
        ckpt = os.path.join(gangs.out2, "fno", "checkpoint.npz")
    else:
        ckpt = os.path.join(gangs.four, "checkpoint.npz")
        logged = [json.loads(x)["loss"] for x in
                  open(os.path.join(gangs.four, "metrics.jsonl"))]
        rclose(logged, [ref[1], ref[3]])
        assert os.path.exists(os.path.join(gangs.four,
                                           "extrapolation.npy"))
    rclose(meta(ckpt)["losses"], jl)
    assert_params_close(arrays(ckpt), arrays(ref_ckpt))


@pytest.mark.parametrize("name", ["fno_w_k2", "rnn"])
def test_dp_fno_w_pushforward_and_rnn_trajectories(gangs, tmp_path, name):
    """fno_w's 7 two-step windows (4, 3) and rnn's 3 trajectories (2, 1)
    over 2 ranks against dp 1."""
    ref, _ = port_run(cases(gangs.data, gangs.j0)[name],
                      str(tmp_path / name))
    for r in range(2):
        rclose(gangs.two[r][name], ref)


def test_dp_minibatch_draws_keep_the_generator(gangs, tmp_path):
    """batch_size 5 with input noise: every rank draws the whole batch's
    windows and noise, so the losses follow dp 1's draws and the saved
    generator state is dp 1's, bitwise."""
    ref, ref_ckpt = port_run(cases(gangs.data, gangs.j0)["batch"],
                             str(tmp_path / "batch"))
    ckpt = os.path.join(gangs.out2, "batch", "checkpoint.npz")
    rclose(gangs.two[0]["batch"], ref)
    assert meta(ckpt)["torch_generator"] == meta(ref_ckpt)[
        "torch_generator"]


def test_dp_resume_is_bitwise(gangs):
    """2 + 2 iterations at dp 2 equal 4: losses and checkpoint, bitwise."""
    two = gangs.two[0]
    assert two["resumed"] == two["batch"]
    got = arrays(os.path.join(gangs.out2, "resumed", "checkpoint.npz"))
    want = arrays(os.path.join(gangs.out2, "batch", "checkpoint.npz"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_dp_makes_all_reduces_only(gangs):
    """tests/test_collectives.py:224: one iteration is the loss's
    all-reduce and the gradients' (one flat buffer), no all_gather, no
    all_to_all, no halo; all on 'data'."""
    assert gangs.two[0]["counts"] == {"all_reduce": 2, "all_reduce@data": 2}


@pytest.mark.parametrize("name,needle", [
    ("dp_over_world", "dp=4 > 2 available devices"),
    ("basis", "batch axis"),
    ("dp_under_world", "dp=1 < 2 devices")])
def test_dp_errors(gangs, name, needle):
    assert needle in gangs.two[1]["errors"][name]


def test_dp_without_a_process_group_raises(tmp_path):
    """No process group: a world of 1, so dp 2 names the devices, as the
    JAX Trainer does (tests/test_trainer.py:478)."""
    os.makedirs(tmp_path / "d")
    write_data(str(tmp_path / "d"))
    kw = cases(str(tmp_path / "d"), None)["fno"]
    with pytest.raises(ValueError, match="devices"):
        ttr.Trainer(_cfg(kw, str(tmp_path / "o"), dp=2, resume=None),
                    device="cpu")
    with pytest.raises(ValueError, match="batch axis"):
        ttr.Trainer(_cfg(kw, str(tmp_path / "o"), dp=2, model="basis_ode",
                         resume=None), device="cpu")
    assert tens.ensemble_mesh(4) is None
    assert ttr.make_dp_mesh(_cfg(kw, "o", model="basis_ode")) is None


def test_ensemble_mesh_shards_members(gangs, tmp_path):
    """ensemble_mesh on 2 ranks: {'ensemble': 2} for 2 and 4 members,
    None for 3; EnsembleTrainer(mesh='auto') trains one member a rank,
    and its losses and the coordinator's checkpoint (the whole model
    axis) equal the single-device EnsembleTrainer's, bitwise."""
    kw = {k: v for k, v in cases(gangs.data, None)["fno"].items()
          if k != "resume"}
    tr = tens.EnsembleTrainer(_cfg(kw, str(tmp_path / "ens")), 2, mesh=None,
                              device="cpu")
    ref = tr.train(progress=False)
    for r in range(2):
        res = gangs.two[r]["ensemble"]
        assert res["meshes"] == [{"ensemble": 2}, None, {"ensemble": 2}]
        assert res["share"] == [r, r + 1]
        assert res["losses"] == ref
    got = arrays(os.path.join(gangs.out2, "ens", "checkpoint.npz"))
    want = arrays(str(tmp_path / "ens" / "checkpoint.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert meta(os.path.join(gangs.out2, "ens", "checkpoint.npz"))[
        "n_models"] == 2


def test_cli_dist_needs_the_launcher(tmp_path, capsys, monkeypatch):
    from ns_tpu_torch.cli import train as cli
    for var in ("NS_TPU_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit):
        cli.main(["--npz-path", "unused.npz", "--device", "cpu", "--dist"])
    assert "python -m ns_tpu_torch.launch" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--npz-path", "unused.npz", "--device", "cpu", "--dp",
                  "2", "--n-models", "2"])
    assert "--dp shards single-model training" in capsys.readouterr().err
