"""A run end to end on the CPU at tiny sizes, with the harness's look for
a card skipped: the result line's schema, `correct` on a sound run, and
`correct` false for each fault a cell can have, planted under the timed
path; the control fails its cell's limits; a run without a card, or
without the program, prints no result."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench import run
from port_bench.harness import check, guard, spec
from port_bench.tests import tiny

CELLS = [w["name"] for w in
         spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


def _run(cell, traced=False, seconds=0.6):
    return run.execute(cell, 4_000_000_007, seconds, traced, "cpu",
                       t0=time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_well_formed(tmp_path, name):
    cell = tiny.cell(tmp_path, name)
    res = _run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == units
    assert all(isinstance(v["value"], float) and v["value"] > 0
               for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(cell.traffic["limits"])
    json.dumps(res)


@pytest.mark.parametrize("name", ["cavity51.ens512", "tgv256.high"])
def test_a_traced_run_has_the_window_and_breakdown(tmp_path, name):
    cell = tiny.cell(tmp_path, name)
    res = _run(cell, traced=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"
    # readers of the host's clock find it on the CPU too (device readers
    # find no device records there)
    host = {m["name"] for m in cell.per_layer if m["source"] == "host_clock"}
    assert host <= set(res["metrics"])
    assert all(v["value"] > 0 for v in res["metrics"].values())


def _identity(fam):
    step = fam.step
    if hasattr(step, "batch_polymorphic"):
        fam.step = lambda state: state
        fam.step.batch_polymorphic = step.batch_polymorphic
    else:
        fam.step = lambda carry: (carry, carry[0])


def _half_batch(fam):
    step = fam.step

    def half(state):
        new = step(state)
        k = state.u.shape[0] // 2
        mix = lambda a, b: torch.cat([a[:k], b[k:]])
        return dataclasses.replace(
            new, u=mix(new.u, state.u), v=mix(new.v, state.v),
            p=mix(new.p, state.p), u_prev=mix(new.u_prev, state.u_prev),
            v_prev=mix(new.v_prev, state.v_prev))
    half.batch_polymorphic = True
    fam.step = half


def _altered(fam):
    job = fam.job

    def altered(entry, span):
        out = job(entry, span)
        if "carry" in out:  # the largest mode of the final spectrum
            u = out["carry"][0].clone()
            flat = u.view(-1)
            flat[flat.abs().argmax()] *= -1
            out["carry"] = (u, out["carry"][1])
        else:  # one cell of the pressure of one member
            p = out["p"].clone()
            p.view(-1)[p.numel() // 2] += 1.0
            out["p"] = p
        return out
    fam.job = altered


FAULTS = [(c, "identity", _identity) for c in CELLS] + \
    [(c, "altered", _altered) for c in CELLS] + \
    [("cavity51.ens512", "half_batch", _half_batch)]


@pytest.mark.parametrize("name,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, monkeypatch,
                                                     name, fault, plant):
    cell = tiny.cell(tmp_path, name)
    family = cell.family()
    build = family.build

    def broken(cell, device):
        fam = build(cell, device)
        plant(fam)
        return fam
    monkeypatch.setattr(family, "build", broken)
    res = _run(cell)
    assert res["attempted"] >= 2
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_its_cell(tmp_path, name):
    cell = tiny.cell(tmp_path, name)
    samples = [(0, None), (4, None)]
    values = check.readings(cell, 99, samples, "cpu",
                            rounding=cell.traffic["control"])
    ok, checks = check.verdict(cell, values)
    assert not ok, checks


def _bare_run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and lines[-1].startswith("{"))


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _bare_run(spec.ROOT)
    assert _no_result(proc), proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    assert _no_result(_bare_run(tmp_path, env))


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["ns_tpu_torch", "ns_tpu_torch.solvers", "jaxtyping", "flaxen",
             "ns_tpu", "ns_tpu.solvers.chorin_fd", "jax.numpy", "jaxlib",
             "flax.linen", "numpy"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "ns_tpu",
        "ns_tpu.solvers.chorin_fd"]


def test_nothing_the_benchmark_runs_imports_jax(tmp_path):
    """Every module of the benchmark, and a whole run of each cell, in a
    fresh process: no jax, jaxlib, flax or ns_tpu in sys.modules."""
    code = f"""
import importlib, pkgutil, sys, time, json
sys.path.insert(0, {str(spec.ROOT)!r})
import port_bench
from port_bench import run
from port_bench.harness import guard
from port_bench.tests import tiny
from pathlib import Path
for sub in ("harness", "families", "inputs", "reference", "metrics",
            "end_to_end", "counts"):
    pkg = importlib.import_module("port_bench." + sub)
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"port_bench.{{sub}}.{{m.name}}")
import port_bench.calibrate
for i, name in enumerate({CELLS!r}):
    cell = tiny.cell(Path({str(tmp_path)!r}) / str(i), name)
    run.execute(cell, 5, 0.2, i == 0, "cpu", t0=time.perf_counter(),
                log=lambda *a: None)
print(json.dumps(guard.forbidden_modules()))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
