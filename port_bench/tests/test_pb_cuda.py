"""On the card: a short run of each cell, in a process of its own as the
benchmark's command starts it, is correct and well formed."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench.harness import spec

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in
         spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable here)")


@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(card, name):
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
