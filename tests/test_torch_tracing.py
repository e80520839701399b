"""The port's tracing on the CPU: spectral3d's spans, the SOR wrappers'
sweep counts (K1, K4, K5 through their twins), the benchmark's readers of
both on hand-built traces, and `cli/profile_run.py`'s device arithmetic."""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from ns_tpu_torch.cli import profile_run
from ns_tpu_torch.ops import kernels, poisson
from ns_tpu_torch.solvers import spectral3d as s3
from ns_tpu_torch.utils import profiling
from port_bench.harness import spec, trace

# --- spectral3d's spans ------------------------------------------------------


def _job(cfg, step, u0):
    """One job of the benchmark's 3D family: init, the steps, the
    diagnostics."""
    carry = s3.init_from_velocity(cfg, u0)
    for _ in range(cfg.nt):
        carry, _ = step(carry)
    return [s3.energy(cfg, carry[0]), s3.enstrophy(cfg, carry[0]),
            s3.divergence_max(cfg, carry[0])]


def _constant_spans(cfg, step, u0):
    """spectral3d.constants and spectral3d.nonlinear spans of one job under
    the profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _job(cfg, step, u0)
    names = [e.name for e in prof.events()]
    return names.count(s3.CONSTANTS_SPAN), names.count(s3.NONLINEAR_SPAN)


@pytest.mark.parametrize("precision,fused", [("default", True),
                                             ("high", False)])
def test_a_3d_job_after_the_first_records_no_constant_build(precision,
                                                            fused):
    """A 16^3 job of the compact matmul engine under the profiler. The
    constants are cached per (config, device), so a cold job (caches
    cleared) builds at most once per constant call it makes (3 make_ops,
    2 DFT tables, 2 Hermitian weights) and the next job builds none; both
    record nt + 1 `spectral3d.nonlinear` spans (the steps and the AB2
    start)."""
    cfg = s3.Spectral3DConfig(nt=3, nx=16, ny=16, nz=16, transform="matmul",
                              matmul_precision=precision,
                              use_pallas_transform=fused)
    u0 = torch.as_tensor(s3.random_solenoidal_velocity(cfg, seed=3))
    step, _ = s3.make_step(cfg, "cpu")
    for f in s3._CONSTANT_CACHES.values():
        f.cache_clear()
    builds, nonlinear = _constant_spans(cfg, step, u0)
    assert 1 <= builds <= 7
    assert nonlinear == cfg.nt + 1
    assert _constant_spans(cfg, step, u0) == (0, cfg.nt + 1)


def test_spans_are_free_without_a_profiler():
    assert isinstance(profiling.named_scope(s3.CONSTANTS_SPAN),
                      contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert not isinstance(profiling.named_scope(s3.NONLINEAR_SPAN),
                              contextlib.nullcontext)


# --- the SOR wrappers' sweep counts ------------------------------------------

N, H, BETA = (20, 16), 0.1, 1.25


def _fields(scales):
    gen = torch.Generator().manual_seed(5)
    rhs = torch.randn((len(scales), *N), generator=gen, dtype=torch.float64)
    rhs *= torch.tensor(scales, dtype=torch.float64)[:, None, None]
    return torch.zeros_like(rhs), rhs


def _errors(p, rhs, n):
    """max|dp| of each of n red-black sweeps of one field from p."""
    masks = poisson.checkerboard(*p.shape)
    out = []
    for _ in range(n):
        q = poisson.redblack_sweep(p, rhs, H, H, BETA, masks)
        out.append(float((q - p).abs().max()))
        p = q
    return out


def _stop(errs, tol, every=1):
    """The sweep at which a gate read every `every` sweeps first sees
    err <= tol."""
    return next(s for s in range(every, len(errs) + 1, every)
                if errs[s - 1] <= tol)


def test_k1_twin_counts_each_members_sweeps():
    """A batch of four members whose rhs differ in scale, so each stops at
    its own sweep; then the same batch at its cap (nit - 1 sweeps)."""
    p, rhs = _fields([1e-4, 1e-3, 1e-2, 1e-1])
    errs = [_errors(pm, cm, 199) for pm, cm in zip(p, rhs)]
    tol = 1e-4
    stops = [_stop(e, tol) for e in errs]
    assert len(set(stops)) == 4
    kernels.reset_launch_counts()
    kernels.sor_redblack_fused(p, rhs, H, H, BETA, tol, 200)
    assert kernels.sweep_counts()["sor_redblack_fused"] == (sum(stops), 4)
    kernels.sor_redblack_fused(p, rhs, H, H, BETA, 0.0, 30)
    assert kernels.sweep_counts()["sor_redblack_fused"] == (
        sum(stops) + 4 * 29, 8)


@pytest.mark.parametrize("wrapper", ["sor_redblack_packed_multiblock",
                                     "sor_redblack_multiblock"])
def test_k4_k5_twins_count_gate_groups(wrapper):
    """K4's and K5's twins gate every 8 sweeps: a solve that converges
    early stops at the first group whose last sweep is within tol, one at
    its cap runs 8 * gate_groups(nit, 8) sweeps."""
    p, rhs = _fields([1.0])
    errs = _errors(p[0], rhs[0], 200)
    # a tol halfway (in log) between the readings of two gates
    g = 5
    tol = (errs[8 * g - 1] * errs[8 * g - 9]) ** 0.5
    assert _stop(errs, tol, 8) == 8 * g
    fn = getattr(kernels, wrapper)
    kernels.reset_launch_counts()
    fn(p[0], rhs[0], H, H, BETA, tol, 200)
    assert kernels.sweep_counts()[wrapper] == (8 * g, 1)
    fn(p, rhs, H, H, BETA, 0.0, 30)
    capped = 8 * kernels.poisson_kernels.gate_groups(30, 8)
    assert capped == 32
    assert kernels.sweep_counts()[wrapper] == (8 * g + capped, 2)


def test_reset_zeroes_the_sweep_counts():
    p, rhs = _fields([1.0, 2.0])
    kernels.reset_launch_counts()
    kernels.sor_redblack_fused(p, rhs, H, H, BETA, 0.0, 5)
    kernels.sor_redblack_multiblock(p, rhs, H, H, BETA, 0.0, 5)
    assert kernels.sweep_counts() == {
        "sor_redblack_fused": (2 * 4, 2),
        "sor_redblack_packed_multiblock": (0, 0),
        "sor_redblack_multiblock": (2 * 8, 2)}
    kernels.reset_launch_counts()
    assert set(kernels.sweep_counts().values()) == {(0, 0)}


# --- the benchmark's readers on hand-built traces ----------------------------


def _trace(device=(), spans=(), launch=None, t1=1000.0):
    """A window [0, t1) with device records (name, ts, dur, corr) and CPU
    spans (name, ts, dur) on thread 1."""
    return trace.Trace(
        t0=0.0, t1=t1,
        device=[(n, ts, dur, "kernel", corr) for n, ts, dur, corr in device],
        launch=launch or {},
        ranges=[(n, ts, dur, 1, "user_annotation") for n, ts, dur in spans])


def _read(metric, tr, steps=10, nt_job=10):
    ctx = trace.Context(trace=tr, steps=steps,
                        cell=SimpleNamespace(traffic={"nt_job": nt_job}),
                        route={})
    return spec.reader("metrics", metric).read(ctx)


def test_constants_idle_counts_each_idle_instant_once():
    """Records (100, 300) and (200, 400) overlap, (600, 700) stands alone;
    the spans (50, 150), (450, 550) and (500, 650) put two spans over one
    gap. Idle inside spans: 50..100 and 450..600, 200 us of 1000."""
    c = s3.CONSTANTS_SPAN
    tr = _trace(device=[("k", 100, 200, 1), ("k", 200, 200, 2),
                        ("copy", 600, 100, 3)],
                spans=[(c, 50, 100), (c, 450, 100), (c, 500, 150),
                       ("job.diagnostics", 0, 1000)])
    assert _read("constants_idle_pct", tr) == pytest.approx(20.0)
    assert _read("constants_idle_pct", tr) <= _read("device_idle_pct", tr)
    # no span in the window: the constants cost no idle time
    assert _read("constants_idle_pct", _trace(
        device=[("k", 100, 200, 1)])) == 0.0


def test_constant_builds_per_job_counts_spans_that_start_inside():
    c = s3.CONSTANTS_SPAN
    tr = _trace(spans=[(c, -50, 100)] + [(c, 100 * i, 10) for i in range(7)])
    assert _read("constant_builds_per_job", tr, steps=10) == 7.0
    assert _read("constant_builds_per_job", tr, steps=20) == 3.5
    assert _read("constant_builds_per_job", _trace(), steps=10) == 0.0


def test_nonlinear_ms_per_call_reads_kernels_launched_inside():
    """Two nonlinear spans; kernels 1 and 2 launched inside them, kernel 3
    outside: (300 + 100) us over two calls."""
    n = s3.NONLINEAR_SPAN
    tr = _trace(device=[("k", 120, 300, 1), ("k", 520, 100, 2),
                        ("k", 800, 50, 3)],
                spans=[(n, 100, 50), (n, 500, 50)],
                launch={1: (110, 1), 2: (510, 1), 3: (700, 1)})
    assert _read("nonlinear_ms_per_call", tr) == pytest.approx(0.2)


def test_sor_sweeps_per_solve_reads_the_counters():
    p, rhs = _fields([1.0, 10.0])
    kernels.reset_launch_counts()
    assert _read("sor_sweeps_per_solve", _trace()) is None
    kernels.sor_redblack_fused(p, rhs, H, H, BETA, 0.0, 30)
    kernels.sor_redblack_packed_multiblock(p[0], rhs[0], H, H, BETA, 0.0, 30)
    assert _read("sor_sweeps_per_solve", _trace()) == pytest.approx(
        (2 * 29 + 32) / 3)
    kernels.reset_launch_counts()


@pytest.mark.parametrize("metric", ["constants_idle_pct",
                                    "constant_builds_per_job",
                                    "nonlinear_ms_per_call",
                                    "sor_sweeps_per_solve"])
def test_new_readers_return_none_on_an_empty_window(metric):
    assert _read(metric, _trace(), steps=0) is None


# --- cli/profile_run.py's arithmetic -----------------------------------------


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_profile_run_idle_is_one_minus_the_union_over_its_range():
    """The range (100, 1100); records (200, 500) and (300, 600) overlap,
    a copy (800, 900); one record before the range and the range's own
    device-side annotation do not count."""
    events = [_x(profile_run.RANGE, "user_annotation", 100, 1000),
              _x(profile_run.RANGE, "gpu_user_annotation", 150, 950),
              _x("k0", "kernel", 0, 50),
              _x("k1", "kernel", 200, 300), _x("k2", "kernel", 300, 300),
              _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 800, 100)]
    out = profile_run.device_summary(events, nt=3)
    assert out["device_busy_ms"] == pytest.approx(0.5)
    assert out["device_idle_share"] == pytest.approx(0.5)
    assert out["device_records_per_step"] == 1.0
    assert out["memcpy_dtoh_ms"] == pytest.approx(0.1)
    assert out["top_device_ms"][0] == ["k1", 0.3, 1]
    with pytest.raises(ValueError):
        profiling.device_window(events[2:], profile_run.RANGE)


def test_profile_run_sweeps_per_solve_of_the_wrappers_that_solved():
    before = {"a": (10, 1), "b": (5, 1)}
    after = {"a": (410, 3), "b": (5, 1)}
    assert profile_run.sweeps_per_solve(before, after) == {"a": 200.0}


def test_union_counts_overlapping_records_once():
    assert profiling.union_us([(0, 10), (5, 15), (20, 30), (-5, 2)],
                              0, 25) == 15 + 5
