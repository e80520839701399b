"""The port's multi-process runtime (ns_tpu_torch.parallel.distributed) on
a gloo gang of 4 CPU ranks, and its shard files across both packages.

The gang (a module fixture) bootstraps through `initialize`, builds global
arrays from each rank's rows, writes shard files, checks process_local_rows
on a 2x2 mesh and trains an 8-member ensemble over a 4-rank 'ensemble'
mesh (2 members a rank, no collective). Every rank asserts that neither
jax nor ns_tpu was imported. Shard files written by either package
assemble in the other (the JAX side writes from its 8 fake devices in this
process), and the assembly keeps the JAX checks for holes and stale
process counts (tests/test_multiprocess.py:123-211).
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from ns_tpu_torch.models.basis import BasisGRU
from ns_tpu_torch.parallel import distributed as dist
from ns_tpu_torch.parallel import make_mesh
from ns_tpu_torch.parallel.mesh import Sharding, shard
from ns_tpu_torch.train.ensemble import train_ensemble
from test_torch_parallel import run_gang

WORLD = 4
FIELD = np.random.default_rng(0).normal(size=(16, 5))


def ensemble_obs():
    rng = np.random.default_rng(0)
    return torch.tensor(rng.normal(size=(4, 1, 3, 8, 8)) * 0.1,
                        dtype=torch.float64)


def gru_builder():
    return functools.partial(BasisGRU, 2, 8, 8, dtype=torch.float64)


def _rank_worker(rank, world, init, out):
    assert "jax" not in sys.modules
    torch.set_num_threads(1)
    dev = dist.initialize(init, world, rank, "cpu")
    res = {"device": str(dev), "index": dist.process_index(),
           "count": dist.process_count(),
           "coordinator": dist.is_coordinator()}
    mesh = dist.make_global_mesh({"x": world})
    sh = Sharding(mesh, ("x", None))
    lo, hi = dist.process_local_rows(16, mesh, "x")
    g = dist.global_array(sh, FIELD[lo:hi])
    res["index_of_block"] = [list(se) for se in g.index]
    res["shape"] = list(g.shape)
    dist.save_array_shards(os.path.join(out, "rows"), "field", g)
    dist.save_array_shards(os.path.join(out, "replicated"), "field",
                           dist.replicated(mesh, FIELD))
    mesh2 = make_mesh({"ensemble": 2, "x": 2})
    res["rows_2x2"] = list(dist.process_local_rows(32, mesh2, "x"))
    res["rows_of_0"] = list(dist.process_local_rows(32, mesh2, "x", pid=0))
    # the ensemble API over an 'ensemble' mesh: this rank's 2 members
    from ns_tpu_torch.parallel.collectives import COUNTS, reset_counts
    reset_counts()
    params, hist = train_ensemble(gru_builder(), ensemble_obs(), 4,
                                  n_models=8, n_iters=3,
                                  mesh=make_mesh({"ensemble": world}))
    res["ensemble_counts"] = dict(COUNTS)
    esh = Sharding(make_mesh({"ensemble": world}), ("ensemble", None))
    dist.save_array_shards(os.path.join(out, "ensemble"), "hist",
                           dist.global_array(esh, hist.T.contiguous()))
    dist.save_array_shards(
        os.path.join(out, "ensemble"), "basis", dist.global_array(
            esh, params["basis"].reshape(2, -1)))
    dist.barrier()
    with open(os.path.join(out, f"results.{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()
    assert "jax" not in sys.modules
    assert not any(m.split(".")[0] == "ns_tpu" for m in sys.modules)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_gang"))
    run_gang(_rank_worker, WORLD, out)
    results = [json.load(open(os.path.join(out, f"results.{r}.json")))
               for r in range(WORLD)]
    return out, results


def test_initialize_and_process_queries(gang):
    _, results = gang
    for r, res in enumerate(results):
        assert res["device"] == "cpu"
        assert res["index"] == r and res["count"] == WORLD
        assert res["coordinator"] == (r == 0)


def test_global_array_from_local_rows(gang):
    """tests/test_multiprocess.py::test_global_array_matches_device_put:
    each rank's rows make one global array; its blocks reassemble to the
    field."""
    out, results = gang
    for r, res in enumerate(results):
        assert res["index_of_block"] == [[4 * r, 4 * r + 4], [0, 5]]
        assert res["shape"] == [16, 5]
    np.testing.assert_array_equal(
        dist.assemble_shards(os.path.join(out, "rows"), "field"), FIELD)
    np.testing.assert_array_equal(
        dist.assemble_shards(os.path.join(out, "replicated"), "field"),
        FIELD)
    files = sorted(os.listdir(os.path.join(out, "rows")))
    assert files == [f"field.proc{r:04d}.npz" for r in range(WORLD)]


def test_process_local_rows_contiguous(gang):
    """tests/test_multiprocess.py::test_process_local_rows_contiguous on a
    2x2 (ensemble, x) mesh: the row sharding replicates over 'ensemble'."""
    _, results = gang
    for r, res in enumerate(results):
        half = r % 2
        assert res["rows_2x2"] == [16 * half, 16 * half + 16]
        assert res["rows_of_0"] == [0, 16]


def test_port_shards_assemble_in_jax(gang):
    from ns_tpu.parallel import distributed as jdist
    out, _ = gang
    np.testing.assert_array_equal(
        jdist.assemble_shards(os.path.join(out, "rows"), "field"), FIELD)


def test_jax_shards_assemble_in_port(tmp_path):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ns_tpu.parallel import distributed as jdist
    from ns_tpu.parallel.mesh import make_mesh as jmesh
    mesh = jmesh({"x": 4}, devices=jax.devices()[:4])
    arr = np.arange(64, dtype=np.float64).reshape(8, 8)
    jdist.save_array_shards(str(tmp_path), "field", jax.device_put(
        arr, NamedSharding(mesh, P("x", None))))
    back = dist.assemble_shards(str(tmp_path), "field")
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)


def test_shard_io_roundtrip_single_process(tmp_path):
    """tests/test_multiprocess.py:123: a world of 1 (no process group)
    writes one file that reassembles, in both packages."""
    from ns_tpu.parallel import distributed as jdist
    mesh = make_mesh({"x": 1}, device_type="cpu")
    arr = np.arange(64, dtype=np.float64).reshape(8, 8)
    dist.save_array_shards(str(tmp_path), "field",
                           shard(Sharding(mesh, ("x", None)), arr))
    assert [p.name for p in tmp_path.glob("field.proc*.npz")] == [
        "field.proc0000.npz"]
    np.testing.assert_array_equal(dist.assemble_shards(str(tmp_path),
                                                       "field"), arr)
    np.testing.assert_array_equal(jdist.assemble_shards(str(tmp_path),
                                                        "field"), arr)


def _write(path, pid, num_processes, rows, value):
    manifest = {"name": "x", "process": pid, "num_processes": num_processes,
                "global_shape": [4, 4], "dtype": "float64",
                "shards": [{"key": "shard0",
                            "index": [[rows[0], rows[1]], [0, 4]]}]}
    np.savez(path / f"x.proc{pid:04d}.npz",
             __manifest__=np.frombuffer(json.dumps(manifest).encode(),
                                        dtype=np.uint8),
             shard0=np.full((rows[1] - rows[0], 4), value))


def test_assemble_shards_detects_holes(tmp_path):
    _write(tmp_path, 0, 1, (0, 2), 1.0)
    with pytest.raises(ValueError, match="do not cover"):
        dist.assemble_shards(str(tmp_path), "x")
    with pytest.raises(FileNotFoundError):
        dist.assemble_shards(str(tmp_path), "y")


def test_assemble_shards_rejects_stale_process_count(tmp_path):
    """A stale 4-process set beside a fresh 2-process one is rejected."""
    _write(tmp_path, 0, 2, (0, 2), 1.0)
    _write(tmp_path, 1, 2, (2, 4), 1.0)
    _write(tmp_path, 2, 4, (2, 3), 99.0)
    _write(tmp_path, 3, 4, (3, 4), 99.0)
    with pytest.raises(ValueError, match="stale"):
        dist.assemble_shards(str(tmp_path), "x")


def test_train_ensemble_over_an_ensemble_mesh(gang):
    """tests/test_runtime.py:62 (train_ensemble with a mesh): each rank
    trains its 2 of the 8 members with no collective, and the shares equal
    the single-process run's members."""
    out, results = gang
    params, hist = train_ensemble(gru_builder(), ensemble_obs(), 4,
                                  n_models=8, n_iters=3, device="cpu")
    got_hist = dist.assemble_shards(os.path.join(out, "ensemble"), "hist")
    got_basis = dist.assemble_shards(os.path.join(out, "ensemble"), "basis")
    np.testing.assert_allclose(got_hist, hist.T.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got_basis,
                               params["basis"].reshape(8, -1).numpy(),
                               rtol=0, atol=1e-12)
    assert all(res["ensemble_counts"] == {} for res in results)


def test_initialize_refusals(monkeypatch):
    for var in ("NS_TPU_COORDINATOR", "MASTER_ADDR", "NS_TPU_PLATFORM",
                "NS_TPU_LOCAL_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="owns one device"):
        dist.initialize("127.0.0.1:1", 1, 0, "cpu", local_device_count=2)
    with pytest.raises(ValueError, match="no coordinator"):
        dist.initialize(platform="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.initialize("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()
    assert dist.process_index() == 0 and dist.process_count() == 1
