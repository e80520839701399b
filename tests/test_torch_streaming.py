"""The port's streaming writer (ns_tpu_torch.io) against the JAX package's,
on the CPU.

Every case of tests/test_native_io.py is mirrored for the port's
`AsyncNpyWriter` (its native backend is the port's own copy of the C++
writer, built with g++ into ns_tpu_torch/_build/), except the jit-cache
bound, which has no counterpart: the port compiles nothing. Every backend
must give byte-identical, np.load-compatible files.

`stream_rollout`'s files equal the port's in-memory rollout bitwise (the
same steps and the same extraction, chunk by chunk) and the JAX package's
`stream_rollout` within 1e-10 of max at dtype=np.float64.
"""

import os
import time

import numpy as np
import pytest
import torch

import ns_tpu_torch
from ns_tpu_torch.io import AsyncNpyWriter, stream_rollout
from ns_tpu_torch.runtime.native import build as native_build

BACKENDS = ["native", "thread", "sync"]


def test_native_library_builds_into_the_port_build_dir():
    """The C++ backend builds from the port's copy of the source into
    ns_tpu_torch/_build/, never next to the source and never from (or
    into) the JAX package's runtime/native/."""
    lib = native_build.load()
    assert lib is not None
    pkg = os.path.dirname(os.path.abspath(ns_tpu_torch.__file__))
    assert native_build._SRC == os.path.join(pkg, "csrc",
                                             "stream_writer.cpp")
    assert native_build._SO == os.path.join(pkg, "_build", "_ns_native.so")
    assert os.path.isfile(native_build._SO)
    assert "ns_tpu/runtime" not in native_build._SO.replace(os.sep, "/")


@pytest.mark.parametrize("backend", BACKENDS)
def test_round_trip(tmp_path, backend):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((13, 5, 7)).astype(np.float32)
    path = str(tmp_path / f"{backend}.npy")
    with AsyncNpyWriter(path, data.shape, np.float32, backend=backend) as w:
        assert w.backend == backend
        # out-of-order, variable-size ranges
        w.write(6, data[6:13])
        w.write(0, data[0:4])
        w.write(4, data[4:6])
    np.testing.assert_array_equal(np.load(path), data)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dtype_cast_and_many_chunks(tmp_path, backend):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((64, 33)).astype(np.float64)
    path = str(tmp_path / "cast.npy")
    with AsyncNpyWriter(path, data.shape, np.float32, backend=backend) as w:
        for t in range(0, 64, 8):
            w.write(t, data[t:t + 8])
    np.testing.assert_array_equal(np.load(path), data.astype(np.float32))


def test_auto_backend_is_native_where_it_builds(tmp_path):
    with AsyncNpyWriter(str(tmp_path / "a.npy"), (2, 3)) as w:
        assert w.backend == "native"
        w.write(0, np.ones((2, 3), np.float32))


def test_shape_and_range_validation(tmp_path):
    w = AsyncNpyWriter(str(tmp_path / "v.npy"), (4, 3), backend="sync")
    with pytest.raises(ValueError):
        w.write(0, np.zeros((2, 5), np.float32))
    with pytest.raises(IndexError):
        w.write(3, np.zeros((2, 3), np.float32))
    w.close()
    np.testing.assert_array_equal(np.load(str(tmp_path / "v.npy")),
                                  np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="backend"):
        AsyncNpyWriter(str(tmp_path / "b.npy"), (4, 3), backend="mmap")


@pytest.mark.parametrize("writer", BACKENDS + ["memmap"])
def test_stream_rollout_writer_parity(tmp_path, writer):
    """stream_rollout output is writer-independent (async paths match the
    synchronous memmap store bit for bit), and equals the JAX package's on
    the same step."""
    import jax.numpy as jnp

    from ns_tpu.io.streaming import stream_rollout as jax_stream

    def step(s):
        return {"x": s["x"] * 1.5 + 1.0}

    def extract(s):
        return {"u": s["x"], "usq": s["x"] ** 2}

    state0 = {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    paths = stream_rollout(step, state0, nt=11, extract=extract,
                           out_dir=str(tmp_path / writer), chunk=4,
                           writer=writer)
    ref = stream_rollout(step, state0, nt=11, extract=extract,
                         out_dir=str(tmp_path / "ref"), chunk=4,
                         writer="memmap")
    jax_paths = jax_stream(step, {"x": jnp.arange(6, dtype=jnp.float32)
                                  .reshape(2, 3)}, nt=11, extract=extract,
                           out_dir=str(tmp_path / "jax"), chunk=4,
                           writer="sync")
    for name in ("u", "usq"):
        got = np.load(paths[name])
        assert got.shape == (11, 2, 3)
        np.testing.assert_array_equal(got, np.load(ref[name]))
        np.testing.assert_array_equal(got, np.load(jax_paths[name]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_write_after_close_raises(tmp_path, backend):
    """write() on a closed writer raises, never segfaults (native: a NULL
    handle into the C library) or silently drops data (thread: a queue
    whose worker already exited)."""
    w = AsyncNpyWriter(str(tmp_path / "wac.npy"), (4, 3), backend=backend)
    w.write(0, np.zeros((4, 3), np.float32))
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.write(1, np.zeros((1, 3), np.float32))
    w.close()  # idempotent


def test_thread_backend_error_surfaces_before_close(tmp_path):
    """A failed disk stops the rollout on the NEXT write, not at close()."""
    w = AsyncNpyWriter(str(tmp_path / "err.npy"), (128, 4),
                       backend="thread")
    os.close(w._fd)                      # the disk goes away
    frame = np.zeros((1, 4), np.float32)
    raised = False
    for i in range(200):                 # poll: the worker fails async
        try:
            w.write(i % 128, frame)
        except OSError:
            raised = True
            break
        time.sleep(0.005)
    assert raised, "write-path never surfaced the worker's OSError"
    with pytest.raises(OSError):
        w.close()


def test_large_backpressure(tmp_path):
    """Submitting far more than the native ring's bound blocks and drains,
    without failing or reordering."""
    data = np.arange(32 * 1024, dtype=np.float32).reshape(32, 1024)
    path = str(tmp_path / "bp.npy")
    with AsyncNpyWriter(path, data.shape, np.float32, backend="native",
                        max_buffer_bytes=8 * 1024) as w:
        for t in range(32):
            w.write(t, data[t:t + 1])
    np.testing.assert_array_equal(np.load(path), data)


def test_thread_backend_byte_backpressure(tmp_path):
    """The Python worker bounds BYTES in flight like the C++ ring."""
    data = np.arange(64 * 256, dtype=np.float32).reshape(64, 256)
    path = str(tmp_path / "tbp.npy")
    with AsyncNpyWriter(path, data.shape, np.float32, backend="thread",
                        max_buffer_bytes=2048) as w:
        for t in range(0, 64, 4):
            w.write(t, data[t:t + 4])   # 4 KB per submit > 2 KB bound
    np.testing.assert_array_equal(np.load(path), data)


def test_load_with_missing_source_returns_prebuilt(tmp_path, monkeypatch):
    """A built library without its source loads (None only when no native
    path exists)."""
    assert native_build.load() is not None
    monkeypatch.setattr(native_build, "_SRC", str(tmp_path / "gone.cpp"))
    monkeypatch.setattr(native_build, "_lib", None)
    monkeypatch.setattr(native_build, "_tried", False)
    assert native_build.load() is not None


def test_stream_rollout_closes_writers_on_failure(tmp_path):
    """A step that fails mid-rollout propagates its error; the writers of
    the chunks already written are closed (their files complete)."""
    calls = []

    def step(x):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("step failed")
        return x + 1.0

    with pytest.raises(RuntimeError, match="step failed"):
        stream_rollout(step, torch.zeros(2), nt=9,
                       extract=lambda x: {"x": x},
                       out_dir=str(tmp_path), chunk=2, writer="thread")
    got = np.load(str(tmp_path / "x.npy"))
    np.testing.assert_array_equal(got[:4, 0], [1.0, 2.0, 3.0, 4.0])


def test_stream_rollout_empty_and_chunk_validation(tmp_path):
    paths = stream_rollout(lambda x: x + 1.0, torch.zeros(3, 2), nt=0,
                           extract=lambda x: {"x": x},
                           out_dir=str(tmp_path))
    assert np.load(paths["x"]).shape == (0, 3, 2)
    with pytest.raises(ValueError, match="chunk"):
        stream_rollout(lambda x: x, torch.zeros(1), nt=2,
                       extract=lambda x: {"x": x}, out_dir=str(tmp_path),
                       chunk=0)


def _cavity(family, nx, nt, method="explicit"):
    from ns_tpu_torch.cli.run_solver import cavity_bcs
    from ns_tpu_torch.solvers import chorin_fd, direct_fd

    u_bc, v_bc, p_bc = cavity_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    z = np.zeros((nx, nx))
    kw = dict(nt=nt, nx=nx, ny=nx, dt=1e-3, nu=0.1, dtype=torch.float64,
              device="cpu")
    if family == "chorin_fd":
        return chorin_fd.NavierStokesSystem(z, z, z, u_bc, v_bc, p_bc,
                                            nit=60, method=method, **kw)
    return direct_fd.NavierStokesSystem(z, z, z, u_bc, v_bc, p_bc, nit=20,
                                        **kw)


@pytest.mark.parametrize("family,chunk", [("chorin_fd", 3),
                                          ("direct_fd", 64)])
def test_streamed_cavity_equals_in_memory_and_jax(tmp_path, family, chunk):
    """An FD rollout streamed in chunks equals the same system's
    simulate() bitwise, and the JAX package's streamed rollout of the same
    cavity within 1e-10 of max (float64 files)."""
    import jax.numpy as jnp

    from ns_tpu.cli.run_solver import cavity_bcs as j_bcs
    from ns_tpu.io.streaming import stream_rollout as jax_stream
    from ns_tpu.solvers import chorin_fd as jc
    from ns_tpu.solvers import direct_fd as jd

    nx, nt = 17, 7
    sys_ = _cavity(family, nx, nt)
    extract = lambda s: {"u": s.u, "v": s.v, "p": s.p}  # noqa: E731
    paths = stream_rollout(sys_._step, sys_.state0, nt, extract,
                           str(tmp_path / "t"), chunk=chunk,
                           dtype=np.float64)
    want = [a.numpy() for a in sys_.simulate()]

    u_bc, v_bc, p_bc = j_bcs(2.0 / (nx - 1), 2.0 / (nx - 1))
    z = np.zeros((nx, nx))
    kw = dict(nt=nt, nx=nx, ny=nx, dt=1e-3, nu=0.1, dtype=jnp.float64)
    if family == "chorin_fd":
        jsys = jc.NavierStokesSystem(z, z, z, u_bc, v_bc, p_bc, nit=60,
                                     method="explicit", **kw)
    else:
        jsys = jd.NavierStokesSystem(z, z, z, u_bc, v_bc, p_bc, nit=20,
                                     **kw)
    jpaths = jax_stream(jsys._step, jsys.state0, nt, extract,
                        str(tmp_path / "j"), chunk=chunk, dtype=np.float64)
    for name, ref in zip("uvp", want):
        got = np.load(paths[name])
        assert got.shape == (nt, nx, nx) and got.dtype == np.float64
        np.testing.assert_array_equal(got, ref)
        jax_got = np.load(jpaths[name])
        scale = max(1.0, float(np.abs(jax_got).max()))
        assert float(np.abs(got - jax_got).max()) <= 1e-10 * scale


def test_streamed_periodic_equals_in_memory_and_jax(tmp_path):
    """The 2D periodic rollout (compact engine) streamed as the CLI
    streams it equals the system's simulate() bitwise, and the JAX
    package's within 1e-10 of max (float64)."""
    from ns_tpu.io.streaming import stream_rollout as jax_stream
    from ns_tpu.solvers import spectral_periodic as jsp
    from ns_tpu_torch.solvers import spectral_periodic as sp

    kw = dict(nt=6, nx=16, ny=16, dt=1e-3, nu=1e-3, dtype="float64",
              transform="matmul", matmul_precision="highest",
              compact_spectrum=True)
    cfg = sp.SpectralPeriodicConfig(**kw)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=2)
    sys_ = sp.NavierStokesSystem(w0, device="cpu", **kw)
    extract = lambda c: dict(zip("uvp", sys_._extract(c[0])))  # noqa: E731
    paths = stream_rollout(lambda c: sys_._step(c)[0], sys_.carry0, cfg.nt,
                           extract, str(tmp_path / "t"), chunk=4,
                           dtype=np.float64)
    want = [a.numpy() for a in sys_.simulate()]

    jcfg = jsp.SpectralPeriodicConfig(**kw)
    jstep, _ = jsp.make_step(jcfg)

    def jextract(c):
        w_hat = jsp.expand_compact(jcfg, c[0])
        u, v, _ = jsp.fields_from_hat(jcfg, w_hat)
        return {"u": u, "v": v, "p": jsp.pressure_from_hat(jcfg, w_hat)}

    jpaths = jax_stream(lambda c: jstep(c)[0],
                        jsp.init_from_vorticity(jcfg, w0), cfg.nt, jextract,
                        str(tmp_path / "j"), chunk=4, dtype=np.float64)
    for name, ref in zip("uvp", want):
        got = np.load(paths[name])
        np.testing.assert_array_equal(got, ref)
        jax_got = np.load(jpaths[name])
        scale = max(1.0, float(np.abs(jax_got).max()))
        assert float(np.abs(got - jax_got).max()) <= 1e-10 * scale


@pytest.mark.parametrize("argv", [
    ["direct_fd", "--nx", "17"],
    ["decaying_turbulence", "--nx", "16", "--transform", "matmul",
     "--compact", "--precision", "highest", "--seed", "1"],
])
def test_cli_stream_dir_matches_jax_cli(tmp_path, argv):
    """run_solver --stream-dir writes the JAX CLI's files (u/v/p; u/v/p/w
    for the periodic families): float64 rollouts stored as the float32
    files both CLIs write, within one float32 rounding (rtol 2^-23) or
    the npz runs' atol 1e-9 (values at rounding-noise level)."""
    from ns_tpu.cli import run_solver as j_cli
    from ns_tpu_torch.cli import run_solver as t_cli

    common = ["--nt", "4", "--dtype", "float64"]
    j_cli.main(argv + common + ["--stream-dir", str(tmp_path / "j")])
    summary = t_cli.main(argv + common + ["--device", "cpu", "--stream-dir",
                                          str(tmp_path / "t")])
    assert summary["out"] == str(tmp_path / "t")
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert names == (["p.npy", "u.npy", "v.npy", "w.npy"]
                     if argv[0] == "decaying_turbulence"
                     else ["p.npy", "u.npy", "v.npy"])
    for name in names:
        j, t = np.load(tmp_path / "j" / name), np.load(tmp_path / "t" / name)
        assert t.shape == j.shape and t.shape[0] == 4
        np.testing.assert_allclose(t, j, rtol=2.0**-23, atol=1e-9)
