"""Tiny copies of the benchmark's data for CPU tests: the real cell and
configuration files with grids, members, steps and pool cut to a size the
CPU runs in seconds, everything else (limits included) as committed."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from port_bench.harness import spec

SHRINK_CONFIG = {"tgv3d_re1600": {"nx": 24, "ny": 24, "nz": 24}}
SHRINK_CELL = {
    "tgv256.default": {"pool": 3},
    "tgv256.high": {"pool": 3},
    "cavity1024.sor": {"n": 33, "nt_job": 5, "pool": 3},
    "cavity51.ens512": {"members": 4, "nt_job": 5, "pool": 3},
}


def data_root(tmp: Path) -> Path:
    """A data root under `tmp` with tiny cells and configurations, and a
    copy of BENCHMARK.json at `tmp / "BENCHMARK.json"`."""
    for sub in ("configs", "cells"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    for src in (spec.BENCH_DIR / "configs").glob("*.json"):
        c = spec.load_json(src)
        c.update(SHRINK_CONFIG.get(c["name"], {}))
        (tmp / "configs" / src.name).write_text(json.dumps(c))
    for src in (spec.BENCH_DIR / "cells").glob("*.json"):
        t = spec.load_json(src)
        t.update(SHRINK_CELL.get(t["name"], {}))
        (tmp / "cells" / src.name).write_text(json.dumps(t))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def cell(tmp: Path, name: str):
    root = data_root(tmp)
    return spec.load_cell(name, data_root=root,
                          benchmark=root / "BENCHMARK.json")
