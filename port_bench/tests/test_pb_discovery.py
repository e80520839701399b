"""Discovery by name, and BENCHMARK.json against the benchmark contract's
static rules: every cell, configuration and metric has its files, and a
cell added as new files alone is found and run."""

import json
import re
import time

import pytest

from port_bench import run
from port_bench.harness import spec
from port_bench.tests import tiny

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert ONE_LINE.match(w["why"]) and spec.NAME.match(w["traffic"])
        assert w["chips"] == 1
    for c in BENCH["configs"]:
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        reader = spec.reader("end_to_end", m["name"])
        assert reader.UNIT == m["unit"]
    cells = {w["name"] for w in BENCH["workloads"]}

    def reporting(metrics, quantity):
        per = [set(m["workloads"]) for m in metrics
               if m["name"].split(".")[0] == quantity]
        # each cell reports the quantity under at most one variant
        assert sum(len(w) for w in per) == len(set().union(*per))
        return set().union(*per)

    assert reporting(e2e.values(), "cell_updates_per_s") == cells
    # the job tail is held end to end where it is steady, and reported
    # per layer from the traced jobs in the other cells
    tail = reporting(e2e.values(), "job_p95_ms")
    traced = reporting(BENCH["per_layer"], "traced_job_p95_ms")
    assert tail and not tail & traced and tail | traced == cells


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader_declares_its_entry(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    reader = spec.reader("metrics", metric)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        m["layer"], m["unit"], m["source"], m["moves"].split(".")[0])
    moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    # every cell that reads it reports the end-to-end metric it moves
    assert set(m["workloads"]) <= set(moves.get("workloads", m["workloads"]))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_and_modules(name):
    cell = spec.load_cell(name)
    assert cell.traffic["name"] == name
    for mod in (cell.family(), cell.inputs(), cell.reference()):
        assert mod is not None
    conf = next(c for c in BENCH["configs"] if c["name"] == cell.config["name"])
    assert conf["file"] == f"port_bench/configs/{conf['name']}.json"
    assert conf["reduced"] == cell.config["reduced"]
    assert cell.config["source"] == conf["source"]
    # every cell reports set-up, another end-to-end metric, a per-layer one
    names = {m["name"].split(".")[0] for m in cell.end_to_end}
    assert {"setup_s", "cell_updates_per_s"} <= names
    assert cell.per_layer
    assert set(cell.traffic["limits"]) and cell.traffic["control"]


def test_layers_name_one_layer_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_cavity_bcs_are_the_clis():
    from ns_tpu_torch.cli.run_solver import cavity_bcs

    conf = spec.load_json(spec.BENCH_DIR / "configs"
                          / "cavity2d_chorin_explicit.json")
    dx = 2.0 / 50
    for key, bcs in zip(("u_bc", "v_bc", "p_bc"), cavity_bcs(dx, dx)):
        assert [[b.kind, float(b.value), b.side] for b in bcs] == conf[key]


def test_a_cell_added_as_files_alone_is_found_and_run(tmp_path):
    root = tiny.data_root(tmp_path)
    new = dict(spec.load_json(root / "cells" / "cavity1024.sor.json"),
               name="cavity17.added", n=17, nt_job=3, pool=2)
    (root / "cells" / "cavity17.added.json").write_text(json.dumps(new))
    bench = spec.load_json(root / "BENCHMARK.json")
    bench["workloads"].append({"name": "cavity17.added",
                               "config": new["config"], "traffic": "added",
                               "chips": 1, "why": "a cell of files alone"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "cavity1024.sor" in m.get("workloads", []):
            m["workloads"].append("cavity17.added")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("cavity17.added", data_root=root,
                          benchmark=root / "BENCHMARK.json")
    res = run.execute(cell, 2**31 + 5, 0.5, False, "cpu",
                      t0=time.perf_counter(), log=lambda *a: None)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"cell_updates_per_s.fd", "job_p95_ms.fd",
                                   "setup_s"}
    assert res["correct"], res["checks"]
