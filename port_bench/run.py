"""One run of one benchmark cell of ns_tpu_torch on the card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernel library, the solver's constants, the cell's
input pool made on the device from the seed, one warm-up job), then a
closed loop of jobs for `--seconds` (`--trace 0`: the end-to-end metrics)
or a traced window of the cell's `trace_jobs` jobs (`--trace 1`: the
per-layer metrics), then the comparison of a seeded sample of the jobs'
outputs with the plain reference. Prints the route 'auto' took on an
earlier line, each compared number beside its limit as the last lines of
standard error, and one JSON object as the last line of standard output.
Exits non-zero, with no result, without the cards the cell asks for, or
if the process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout (the port's
# own library builds under ns_tpu_torch/_build/, also inside it)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / ".cache" / "port_bench" / _sub)
os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, str(ROOT))

from port_bench.harness import check, guard, loop, spec, trace  # noqa: E402


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _span(name: str):
    from torch.profiler import record_function

    return record_function(name)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t0: float = T0, log=print) -> dict:
    """Set up, run the window, compare; the result object (without the
    process-level checks, which `main` makes)."""
    import torch

    from ns_tpu_torch.ops import kernels as port_kernels

    t = cell.traffic
    torch.set_num_threads(1)
    marks = [("imports", time.perf_counter())]
    fam = cell.family().build(cell, device)
    marks.append(("solver", time.perf_counter()))
    pool = loop.make_pool(cell, seed, device)
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    port_kernels.reset_launch_counts()
    warm = loop.warm_up(fam, pool)
    _sync(device)
    marks.append(("warm-up job", time.perf_counter()))
    launched = {k: v for k, v in port_kernels.launch_counts().items() if v}
    log(f"route: {json.dumps(fam.route)}; hand-written kernel launches in "
        f"one warm-up job: {json.dumps(launched)}")
    log("set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in
        zip([("start", t0)] + marks[:-1], marks)))
    if warm.raised:
        log(warm.errors[0])

    window = loop.Window(setup_seconds=time.perf_counter() - t0)
    sample = loop.Reservoir(t["sample_jobs"], seed)
    tr = None
    if traced:
        tr = trace.capture(
            lambda: loop.warm_up(fam, pool, span=_span),
            lambda: loop.run_jobs(fam, pool, window, sample,
                                  count=t["trace_jobs"], span=_span))
    else:
        loop.run_jobs(fam, pool, window, sample,
                      deadline=time.perf_counter() + seconds)
    _sync(device)
    samples = loop.sampled_outputs(fam, window, sample)
    for err in window.errors:
        log(err)
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if on_card else 0)}
    metrics = {}
    if traced:
        ctx = trace.Context(trace=tr, steps=window.steps, cell=cell,
                            route=fam.route)
        for m in cell.per_layer:
            reader = spec.reader("metrics", m["name"])
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": reader.UNIT}
        dev.update(busy_s=tr.busy_us() * 1e-6, window_s=tr.seconds)
    else:
        for m in cell.end_to_end:
            reader = spec.reader("end_to_end", m["name"])
            value = reader.read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": reader.UNIT}
    if on_card:
        log(f"card: {_power_limit()}")

    # the program's state goes before the reference runs
    del fam, pool, sample, warm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    try:
        values = check.readings(cell, seed, samples, device)
    except Exception as e:  # a reference that cannot run decides nothing
        log(f"reference failed: {e!r}")
        values = {}
    log(f"reference gaps: {json.dumps(values)}")
    ok, checks = check.verdict(cell, values)
    result = {"correct": ok and window.failed == 0 and bool(samples),
              "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    try:
        guard.require_cards(cell.chips)
    except guard.NoCard as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = guard.forbidden_modules()
    if found:
        print(f"port_bench: the process holds {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
