"""Discovery by name: `BENCHMARK.json`, the cells and configurations (data
files), and the modules of families, inputs, references and metrics.

A cell `<name>` is `cells/<name>.json`; its `config` names
`configs/<config>.json`, whose `family` names `families/<family>.py` and
whose name names `reference/<config>.py`; the cell's `inputs` names
`inputs/<kind>.py`. A metric `<quantity>[.<variant>]` is read by
`metrics/<quantity>.py` (per layer) or `end_to_end/<quantity>.py`. Adding any of them takes new files and new entries
in `BENCHMARK.json`, and no edit of a file already there.
"""

from __future__ import annotations

import importlib
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def check_name(name: str, what: str) -> str:
    """A name that may become a file name under the benchmark's folder."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


@dataclass(frozen=True)
class Cell:
    """One workload: its traffic (the cell file), its configuration, and
    the metrics that `BENCHMARK.json` asks of it."""

    name: str
    chips: int
    traffic: dict
    config: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]

    def family(self):
        return module("families", self.config["family"])

    def inputs(self):
        return module("inputs", self.traffic["inputs"])

    def reference(self):
        return module("reference", self.config["name"])


def module(kind: str, name: str):
    """`port_bench.<kind>.<name>`: a family, input kind, reference or
    metric reader, found by its name."""
    return importlib.import_module(f"port_bench.{kind}.{check_name(name, kind)}")


def reader(kind: str, metric: str):
    """The reader of a metric: `<kind>/<quantity>.py` for the name
    `<quantity>` or `<quantity>.<variant>`. A variant is the same quantity
    reported by the cells of one end-to-end metric (`.dns`, `.fd`)."""
    return module(kind, metric.split(".", 1)[0])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, data_root: Path = BENCH_DIR,
              benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell `name` with its configuration and its metrics. Data files
    come from `data_root` (the benchmark's own folder unless a test gives
    another); code modules always from the package."""
    check_name(name, "workload")
    bench = load_json(benchmark)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"workload {name!r} is not in {benchmark}")
    traffic = load_json(data_root / "cells" / f"{name}.json")
    config = load_json(
        data_root / "configs" / f"{check_name(entry['config'], 'config')}.json")
    if traffic.get("config") != entry["config"] or config.get("name") != \
            entry["config"]:
        raise ValueError(f"cell {name!r}: the cell file, the configuration "
                         f"and BENCHMARK.json disagree on its config")
    return Cell(name=name, chips=int(entry["chips"]), traffic=traffic,
                config=config,
                end_to_end=tuple(m for m in bench["end_to_end"]
                                 if _applies(m, name)),
                per_layer=tuple(m for m in bench["per_layer"]
                                if _applies(m, name)))
