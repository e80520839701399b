"""The port's HTTP rollout service (ns_tpu_torch.serve: wire, client,
server, batching, the solver oracles, cli.serve) against the JAX
package's, on the CPU.

Tolerances: the wire bytes are identical. The solver oracles are held
against ns_tpu's in float64 <= 1e-10 of max: the 3D oracle's replies, and
the 2D oracle's frames from one carry (forced and strided too). The 2D
init takes the float32 request's rfft2 in complex64 in both packages, as
the JAX engine does, and two FFT libraries round it ~2e-8 of max apart, so
the 2D init and whole replies are held at 1e-6 of max.
A port server and a JAX server on the same JAX-format checkpoint answer
the same requests within the JAX serve tests' bound (rtol 2e-4, atol
2e-4: float32 rollouts of two packages), reduce members, mean and spread
and the 4xx errors included; coalesced replies against the serialized
engine path within rtol 1e-4, atol 1e-5, with fewer batches than requests
(as tests/test_serve.py). Servers run on port 0 on a daemon thread and are
closed in `finally`.
"""

import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from ns_tpu.serve import server as jserver
from ns_tpu.serve import solver as jsolver
from ns_tpu.serve import wire as jwire
from ns_tpu.serve.engine import InferenceEngine as JaxEngine
from ns_tpu.serve.engine import _build_model as jax_build
from ns_tpu.train import checkpoint as jck
from ns_tpu.train.trainer import TrainConfig as JaxConfig
from ns_tpu_torch import serve
from ns_tpu_torch.serve import batching, server, solver, wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX = 8


def jax_checkpoint(folder, model="fno", n_models=1):
    """A checkpoint as the JAX Trainer writes it, from JAX-initialised
    float32 params (small fno: width 6, modes 3)."""
    cfg = JaxConfig(model=model, npz_path="unused.npz", out_dir=str(folder),
                    n_coeffs=2, fno_modes=3, fno_width=6,
                    fno_transform="matmul")
    m = jax_build(cfg, NX, NX)
    if n_models > 1:
        from ns_tpu.train.ensemble import init_ensemble
        params = init_ensemble(m, n_models, seed=0)
    else:
        params = m.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    meta = {"config": dataclasses.asdict(cfg), "grid": [NX, NX]}
    if n_models > 1:
        meta["n_models"] = n_models
    return jck.save_checkpoint({"params": params, "opt_state": {}},
                               str(folder), meta=meta)


def frames(n, seed=0, shape=(3, NX, NX)):
    return np.random.default_rng(seed).normal(size=(n,) + shape).astype(
        np.float32)


class Running:
    """A server on port 0, served from a daemon thread."""

    def __init__(self, httpd):
        self.httpd = httpd
        self.port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def post(self, path, arr):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request("POST", path, body=wire.npy_bytes(arr))
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def get(self, path):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()


def test_package_exports():
    assert sorted(serve.__all__) == sorted(
        ["InferenceEngine", "SolverEngine", "SolverEngine3D", "ServeClient",
         "ServeError"])
    import ns_tpu.serve as jserve
    assert sorted(serve.__all__) == sorted(jserve.__all__)


@pytest.mark.parametrize("arr", [
    np.arange(24, dtype=np.float32).reshape(2, 3, 4),
    np.random.default_rng(0).normal(size=(5, 3, 8, 8)),
    np.asfortranarray(np.ones((3, 5), np.float32)),
    np.zeros((0, 3), np.float64),
])
def test_npy_bytes_identical(arr):
    assert wire.npy_bytes(arr) == jwire.npy_bytes(arr)
    np.testing.assert_array_equal(wire.npy_parse(jwire.npy_bytes(arr)), arr)


# ---------------------------------------------------------------------------
# Solver oracles
# ---------------------------------------------------------------------------


def _solver_frame(nx, seed=0, **fk):
    """A band-limited (u, v, p) state of the JAX solver (what a client
    holds), float32."""
    from ns_tpu.models.vorticity import dealias_field
    from ns_tpu.solvers import spectral_periodic as jsp

    cfg = jsp.SpectralPeriodicConfig(nt=1, nx=nx, ny=nx, dtype="float64",
                                     **fk)
    w0 = np.asarray(jax.jit(dealias_field)(
        jsp.decaying_turbulence_vorticity(cfg, seed=seed)))
    c0 = jsp.init_from_vorticity(cfg, w0)
    u, v, _ = jsp.fields_from_hat(cfg, c0[0])
    p = jsp.pressure_from_hat(cfg, c0[0])
    return np.stack([np.asarray(a) for a in (u, v, p)]).astype(np.float32)


def close_of_max(got, want, bound=1e-10):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound * scale


@pytest.mark.parametrize("kw,chunk,n", [
    ({}, 2, 5),
    ({"stride": 3}, 64, 4),
    ({"forcing": "kolmogorov", "forcing_k": 2, "forcing_amp": 0.2}, 4, 5),
])
def test_solver_engine_matches_jax(kw, chunk, n):
    """float64: the served frames against the JAX engine's programs run
    from the same carry <= 1e-10 of max (echo, strides, chunks, forcing);
    the init against the JAX engine's init at the float32 request's
    transform (both engines take the request's rfft2 in complex64, with
    their own FFT libraries: ~2e-8 of max apart), and predict as a whole
    at the same bound."""
    import jax.numpy as jnp

    nx = 16
    fk = {k: v for k, v in kw.items() if k.startswith("forcing")}
    frame0 = _solver_frame(nx, **fk)
    common = dict(dt=1e-3, nu=1e-3, dtype="float64", **kw)
    jeng = jsolver.SolverEngine(nx, nx, chunk=8, **common)
    eng = solver.SolverEngine(nx, nx, chunk=chunk, device="cpu", **common)
    got = eng.predict(frame0, n)
    assert got.shape == (n + 1, 3, nx, nx) and got.dtype == np.float64

    carry = eng._init(torch.as_tensor(frame0))
    jcarry = tuple(jnp.asarray(c.numpy()) for c in carry)
    want = [np.asarray(jax.jit(jeng._emit)(jcarry))[None]]
    done = 0
    while done < n:  # the JAX engine's chunk programs, as its predict
        length = min(8, n - done)
        out, jcarry = jeng._chunk_program(length)(jcarry)
        want.append(np.asarray(out))
        done += length
    close_of_max(got, np.concatenate(want))

    jinit = jeng._init_program()(jnp.asarray(frame0))[0]
    for a, b in zip(carry, jinit):
        close_of_max(a.numpy(), np.asarray(b), bound=1e-6)
    close_of_max(got, jeng.predict(frame0, n), bound=1e-6)
    st = eng.stats()
    assert st["model"] == "solver:spectral_periodic"
    assert st["requests"] == 1 and st["compiled_programs"] == 0
    assert st["stride"] == kw.get("stride", 1)


def test_solver_engine_float32_and_stride_contract():
    """float32 replies at the JAX serve tests' bound; stride k serves every
    k-th state of the dense rollout; chunking changes no bit."""
    nx = 16
    frame0 = _solver_frame(nx, seed=1)
    want = jsolver.SolverEngine(nx, nx).predict(frame0, 4)
    dense = solver.SolverEngine(nx, nx, device="cpu").predict(frame0, 8)
    assert dense.dtype == np.float32
    np.testing.assert_allclose(dense[:5], want, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(dense[0], frame0, rtol=1e-5, atol=1e-6)
    strided = solver.SolverEngine(nx, nx, stride=4, chunk=1,
                                  device="cpu").predict(frame0, 2)
    np.testing.assert_array_equal(strided, dense[::4])


def test_solver_engine3d_matches_jax():
    from ns_tpu.solvers import spectral3d as js3

    n = 8
    cfg = js3.Spectral3DConfig(nt=1, nx=n, ny=n, nz=n, dtype="float64")
    u0 = np.asarray(js3.random_solenoidal_velocity(cfg, seed=0, k_peak=2.0))
    frame0 = np.concatenate([u0, np.zeros((1, n, n, n))]).astype(np.float32)
    common = dict(dt=1e-3, nu=1e-3, dtype="float64")
    want = jsolver.SolverEngine3D(n, n, n, chunk=2, **common).predict(
        frame0, 3)
    eng = solver.SolverEngine3D(n, n, n, chunk=16, device="cpu", **common)
    assert eng.cfg.transform == "matmul"   # 'auto', as the JAX engine
    assert eng.cfg.use_pallas_transform is False
    got = eng.predict(frame0, 3)
    assert got.shape == (4, 4, n, n, n)
    close_of_max(got, want)
    assert eng.stats()["model"] == "solver:spectral3d"


def test_solver_engine_validation_as_jax():
    for pkg, kw in ((jsolver, {}), (solver, {"device": "cpu"})):
        eng = pkg.SolverEngine(16, 16, **kw)
        with pytest.raises(ValueError, match="frame0"):
            eng.predict(np.zeros((2, 3, 16, 16), np.float32), 1)
        with pytest.raises(ValueError, match="n_steps"):
            eng.predict(np.zeros((3, 16, 16), np.float32), -1)
        with pytest.raises(ValueError, match="stride"):
            pkg.SolverEngine(16, 16, stride=0, **kw)
        with pytest.raises(ValueError, match="chunk"):
            pkg.SolverEngine(16, 16, chunk=0, **kw)
        e3 = pkg.SolverEngine3D(8, 8, 8, **kw)
        with pytest.raises(ValueError, match="frame0"):
            e3.predict(np.zeros((3, 8, 8, 8), np.float32), 1)
        with pytest.raises(ValueError):
            e3.predict(np.zeros((4, 8, 8, 8), np.float32), -1)
        with pytest.raises(ValueError, match="stride"):
            pkg.SolverEngine3D(8, 8, 8, stride=0, **kw)
    msgs = []
    for pkg, kw in ((jsolver, {}), (solver, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            pkg.SolverEngine(16, 16, **kw).predict(
                np.zeros((3, 8, 16), np.float32), 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# HTTP: the port's server against the JAX server
# ---------------------------------------------------------------------------


def _both_servers(ckpt, coalesce=0):
    j = Running(jserver.make_server(JaxEngine.from_checkpoint(ckpt, chunk=4),
                                    port=0, coalesce=coalesce))
    t = Running(server.make_server(
        serve.InferenceEngine.from_checkpoint(ckpt, chunk=3, device="cpu"),
        port=0, coalesce=coalesce))
    return j, t


def test_servers_answer_alike(tmp_path):
    ckpt = jax_checkpoint(tmp_path)
    j, t = _both_servers(ckpt)
    try:
        sj, hj = j.get("/health")
        st, ht = t.get("/health")
        assert sj == st == 200 and hj == ht
        assert ht == {"ok": True, "model": "fno", "grid": [NX, NX],
                      "n_models": 1}
        x = frames(2, seed=3)
        for path, arr in (("/rollout?steps=4", x[0]),
                          ("/rollout?steps=3&reduce=members", x[0]),
                          ("/rollout?steps=3&reduce=mean", x[0]),
                          ("/rollout?steps=2", x)):
            (cj, bj), (ct, bt) = j.post(path, arr), t.post(path, arr)
            assert cj == ct == 200
            oj, ot = wire.npy_parse(bj), wire.npy_parse(bt)
            assert oj.shape == ot.shape and ot.dtype == np.float32
            np.testing.assert_allclose(ot, oj, rtol=2e-4, atol=2e-4)
        # spread of one member: exactly zero, never the raw fields
        cj, bj = j.post("/rollout?steps=3&reduce=spread", x[0])
        ct, bt = t.post("/rollout?steps=3&reduce=spread", x[0])
        assert cj == ct == 200
        np.testing.assert_array_equal(wire.npy_parse(bt),
                                      wire.npy_parse(bj))
        assert not wire.npy_parse(bt).any()
        # the 4xx errors: a wrong shape (the engine's message), a bad
        # reduce, an empty body, an unknown path
        for method, path, arr, code in (
                ("post", "/rollout?steps=2", np.zeros((3, NX + 1, NX),
                                                      np.float32), 400),
                ("post", "/rollout?steps=2&reduce=median", x[0], 400),
                ("post", "/rollout?steps=-1", x[0], 400),
                ("post", "/rollout?steps=two", x[0], 400),
                ("post", "/nope", x[0], 404)):
            (cj, bj), (ct, bt) = j.post(path, arr), t.post(path, arr)
            assert cj == ct == code, (path, cj, ct)
            assert json.loads(bt)["error"]
        assert b"frame0" in t.post("/rollout?steps=2",
                                   np.zeros((3, NX + 1, NX),
                                            np.float32))[1]
        assert j.get("/nope")[0] == t.get("/nope")[0] == 404
        stats = t.get("/stats")[1]
        assert stats["requests"] >= 5 and stats["compiled_programs"] == 0
    finally:
        j.close()
        t.close()


def test_ensemble_servers_answer_alike(tmp_path):
    ckpt = jax_checkpoint(tmp_path, n_models=2)
    j, t = _both_servers(ckpt)
    try:
        assert t.get("/health")[1]["n_models"] == 2
        x = frames(2, seed=5)
        for path, arr, shape in (
                ("/rollout?steps=3&reduce=members", x[0], (2, 4, 3, NX, NX)),
                ("/rollout?steps=3", x[0], (4, 3, NX, NX)),
                ("/rollout?steps=3&reduce=spread", x[0], (4, 3, NX, NX)),
                ("/rollout?steps=2&reduce=members", x,
                 (2, 2, 3, 3, NX, NX))):
            (cj, bj), (ct, bt) = j.post(path, arr), t.post(path, arr)
            assert cj == ct == 200
            oj, ot = wire.npy_parse(bj), wire.npy_parse(bt)
            assert ot.shape == oj.shape == shape
            np.testing.assert_allclose(ot, oj, rtol=2e-4, atol=2e-4)
    finally:
        j.close()
        t.close()


def test_client_speaks_to_either_server(tmp_path):
    ckpt = jax_checkpoint(tmp_path)
    j, t = _both_servers(ckpt)
    try:
        x = frames(1, seed=7)[0]
        for srv in (j, t):
            c = serve.ServeClient("127.0.0.1", srv.port)
            assert c.health()["grid"] == [NX, NX]
            out = c.rollout(x, 3)
            assert out.shape == (4, 3, NX, NX)
            assert c.stats()["requests"] >= 1
            with pytest.raises(serve.ServeError, match="frame0") as e:
                c.rollout(np.zeros((3, NX + 1, NX), np.float32), 2)
            assert e.value.status == 400
            with pytest.raises(serve.ServeError, match="reduce"):
                c.rollout(x, 2, reduce="median")
        eng = t.httpd.RequestHandlerClass.engine
        np.testing.assert_array_equal(
            serve.ServeClient("127.0.0.1", t.port).rollout(x, 3),
            eng.predict(x, 3))
    finally:
        j.close()
        t.close()


def test_server_with_solver_engines():
    for eng, shape in ((solver.SolverEngine(16, 16, chunk=4, device="cpu"),
                        (3, 16, 16)),
                       (solver.SolverEngine3D(8, 8, 8, chunk=2,
                                              device="cpu"), (4, 8, 8, 8))):
        t = Running(server.make_server(eng, port=0))
        try:
            h = t.get("/health")[1]
            assert h["model"] == eng.model_name
            assert h["grid"] == list(shape[1:])
            code, body = t.post("/rollout?steps=3", np.zeros(shape,
                                                             np.float32))
            assert code == 200
            out = wire.npy_parse(body)
            assert out.shape == (4,) + shape and np.isfinite(out).all()
            code, body = t.post("/rollout?steps=3&reduce=members",
                                np.zeros(shape, np.float32))
            assert wire.npy_parse(body).shape == (1, 4) + shape
            # a batched request to the single-state oracle: 400
            assert t.post("/rollout?steps=1",
                          np.zeros((2,) + shape, np.float32))[0] == 400
        finally:
            t.close()


# ---------------------------------------------------------------------------
# Coalescing (serve/batching.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_models", [1, 2])
def test_coalescing_matches_serialized_and_batches(tmp_path, n_models):
    """Concurrent single-state requests through the coalescing server get
    the serialized engine path's replies (members first for an ensemble)
    in fewer engine calls than requests; client-batched requests keep the
    serialized path; closing the server stops the dispatcher."""
    ckpt = jax_checkpoint(tmp_path, n_models=n_models)
    eng = serve.InferenceEngine.from_checkpoint(ckpt, chunk=4, device="cpu")
    httpd = server.make_server(eng, port=0, coalesce=8)
    assert isinstance(httpd.dispatcher, batching.CoalescingDispatcher)
    t = Running(httpd)
    xs = list(frames(12, seed=11))
    want = [eng.predict(x, 5) for x in xs]
    q = "/rollout?steps=5" + ("&reduce=members" if n_models > 1 else "")
    try:
        with ThreadPoolExecutor(max_workers=12) as ex:
            got = list(ex.map(lambda x: t.post(q, x), xs))
        for (code, body), w in zip(got, want):
            assert code == 200
            out = wire.npy_parse(body)
            assert out.shape == w.shape
            np.testing.assert_allclose(out, w, rtol=1e-4, atol=1e-5)
        st = httpd.dispatcher.stats()
        assert st["coalesced_requests"] >= 12
        assert st["batches"] < 12
        code, body = t.post("/rollout?steps=2", np.stack(xs[:2]))
        assert code == 200
        assert wire.npy_parse(body).shape == (2, 3, 3, NX, NX)
    finally:
        t.close()
    assert not httpd.dispatcher._thread.is_alive()


def test_coalesce_rejected_for_solver_engines():
    for pkg, kw in ((jsolver, {}), (solver, {"device": "cpu"})):
        with pytest.raises(ValueError, match="surrogate"):
            (jserver if pkg is jsolver else server).make_server(
                pkg.SolverEngine(8, 8, **kw), port=0, coalesce=4)


def test_coalescer_delivers_engine_errors_to_every_waiter(tmp_path):
    """A batch that fails raises the engine's error in every request of
    the batch, and the dispatcher serves on afterwards."""
    ckpt = jax_checkpoint(tmp_path)
    eng = serve.InferenceEngine.from_checkpoint(ckpt, chunk=4, device="cpu")
    d = batching.CoalescingDispatcher(eng, max_batch=4, max_wait_ms=200.0)
    try:
        with ThreadPoolExecutor(max_workers=3) as ex:
            futs = [ex.submit(d.submit, np.zeros((3, NX, NX), np.float32),
                              -1) for _ in range(3)]
            for f in futs:
                with pytest.raises(ValueError, match="n_steps"):
                    f.result(timeout=60)
        assert d.stats()["batches"] < 3
        out = d.submit(np.zeros((3, NX, NX), np.float32), 2)
        assert out.shape == (3, 3, NX, NX)
        with pytest.raises(ValueError, match="max_batch"):
            batching.CoalescingDispatcher(eng, max_batch=0)
    finally:
        d.close()
    with pytest.raises(RuntimeError, match="closed"):
        d.submit(np.zeros((3, NX, NX), np.float32), 1)


# ---------------------------------------------------------------------------
# cli.serve
# ---------------------------------------------------------------------------


def test_serve_cli_checks_as_jax():
    from ns_tpu.cli.serve import main as jmain
    from ns_tpu_torch.cli.serve import main as tmain

    for bad in (["--ckpt", "x", "--dims", "3"],
                ["--solver", "--dims", "3", "--forcing", "fno"],
                ["--ckpt", "x", "--forcing", "kolmogorov"],
                ["--ckpt", "x", "--solver"], []):
        for main in (jmain, tmain):
            with pytest.raises(SystemExit) as e:
                main(bad + ["--device", "cpu"] if main is tmain else bad)
            assert e.value.code == 2


def test_serve_cli_serves_a_checkpoint(tmp_path):
    """python -m ns_tpu_torch.cli.serve on port 0: the "serving ... on
    http://..." line, /health, one request, then terminated."""
    ckpt = jax_checkpoint(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "ns_tpu_torch.cli.serve", "--ckpt",
         str(tmp_path), "--port", "0", "--warmup-steps", "2", "--device",
         "cpu", "--quiet"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving"):
                break
        assert lines[0].startswith("warmup:")
        assert lines[-1].startswith("serving fno (8x8) on http://127.0.0.1:")
        port = int(lines[-1].rsplit(":", 1)[1])
        c = serve.ServeClient("127.0.0.1", port, timeout=60)
        assert c.health()["model"] == "fno"
        out = c.rollout(frames(1)[0], 2)
        want = serve.InferenceEngine.from_checkpoint(
            ckpt, device="cpu").predict(frames(1)[0], 2)
        np.testing.assert_array_equal(out, want)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()
