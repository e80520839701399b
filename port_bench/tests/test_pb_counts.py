"""The yardstick's arithmetic: operation and byte counts, the bounds they
give, and the trace reductions the per-layer readers use."""

import math

import pytest

from port_bench.counts import (fft, fused_lamb, momentum_explicit, peaks,
                               spectral3d_step)
from port_bench.harness import spec, trace


def test_kept_rows_of_the_two_thirds_rule():
    assert spectral3d_step.kept(256, False) == 171
    assert spectral3d_step.kept(256, True) == 86
    assert spectral3d_step.kept(16, False) == 11
    assert spectral3d_step.kept(16, True) == 6


def test_step_at_256_is_bound_by_bytes_at_72_us():
    flops, nbytes = spectral3d_step.count(256, 256, 256)
    assert flops == 9 * fft.real_transform_flops(256 ** 3) + 9 * 256 ** 3
    assert flops == pytest.approx(9.21e9, rel=1e-3)
    assert nbytes == 4 * 3 * 171 * 171 * 86 * 8  # 241 MB
    for arithmetic in ("bf16", "tf32"):
        least, bound = peaks.least_seconds(flops, nbytes, arithmetic)
        assert bound == "bytes"
        assert least == pytest.approx(72.06e-6, rel=1e-3)


def test_k8_counts_at_256():
    flops, nbytes = fused_lamb.count(256, 256, 256, 171, 86)
    plane = 256 * 256
    assert flops == 256 * (9 * 2.5 * plane * math.log2(plane) + 9 * plane)
    spectra = 9 * 256 * 171 * 86 * 8
    tables = (2 * 256 * 171 + 2 * 86 * 256) * 8
    assert nbytes == spectra + tables
    least, bound = peaks.least_seconds(flops, nbytes, "bf16")
    assert bound == "bytes" and least == pytest.approx(81.2e-6, rel=1e-2)


def test_k3_counts():
    flops, nbytes = momentum_explicit.count(1024, 1024)
    assert flops == 84 * 1022 * 1022
    assert nbytes == 6 * 1024 * 1024 * 4
    f512, b512 = momentum_explicit.count(51, 51, 512)
    assert (f512, b512) == (84 * 49 * 49 * 512, 6 * 51 * 51 * 512 * 4)
    assert peaks.least_seconds(flops, nbytes, "fp32")[1] == "bytes"


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0, "bf16") == (1.0, "ops")
    assert peaks.least_seconds(0, 3.35e12, "bf16") == (1.0, "bytes")


def test_union_counts_overlaps_once_and_clips():
    ivs = [(0, 10), (5, 15), (20, 30), (-5, 2), (28, 40)]
    assert trace.union_us(ivs, 0, 35) == 15 + 15


def _events():
    """A synthetic Chrome trace: a 1000 us window, two kernels launched
    inside a pressure span, one GEMM, one copy overlapping a kernel."""
    x = lambda name, cat, ts, dur, **args: {
        "ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
        "tid": 1, "args": args}
    return [
        x(trace.WINDOW, "user_annotation", 0, 1000),
        x("chorin_fd.pressure", "user_annotation", 100, 50),
        x("cudaLaunchKernel", "cuda_runtime", 110, 5, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", 120, 5, correlation=2),
        x("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=3),
        x("aten::mm", "cpu_op", 295, 20),
        x("void sor_packed_resident_kernel<float>", "kernel", 200, 100,
          correlation=1),
        x("void momentum_kernel<float>", "kernel", 310, 40, correlation=2),
        x("sm90_xmma_gemm_f32f32", "kernel", 400, 200, correlation=3),
        x("Memcpy DtoH", "gpu_memcpy", 550, 100),
        x("void momentum_kernel<float>", "kernel", 2000, 5, correlation=9),
    ]


def test_trace_metrics_on_a_synthetic_window():
    tr = trace.parse(_events())
    assert tr.seconds == pytest.approx(1e-3)
    assert len(tr.device) == 4          # the record after the window is out
    assert tr.busy_us() == 100 + 40 + 250
    ctx = trace.Context(trace=tr, steps=2, cell=None, route={})
    read = lambda m: spec.reader("metrics", m).read(ctx)
    assert read("device_idle_pct") == pytest.approx(61.0)
    assert read("launches_per_step") == 2.0
    assert read("pressure_ms_per_step") == pytest.approx(0.140 / 2)
    assert read("gemm_ms_per_step") == pytest.approx(0.100)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0] == "sm90_xmma_gemm_f32f32"
    assert bd["device_ops"][0][1] == pytest.approx(200e-6)
    assert all(len(bd[k]) <= 10 for k in bd)
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(610e-6)


def test_readers_find_nothing_in_an_empty_window():
    tr = trace.parse(_events()[:1])
    ctx = trace.Context(trace=tr, steps=0, cell=None, route={})
    for m in spec.load_json(spec.ROOT / "BENCHMARK.json")["per_layer"]:
        assert spec.reader("metrics", m["name"]).read(ctx) is None
