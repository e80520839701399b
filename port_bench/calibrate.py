"""Readings from which a cell's limits are set: the compared numbers of
the program over many seeds, and of the control (the reference at the
cell's `control` precision put in the program's place) on the same jobs'
inputs, in one process. The benchmark's runs never call this.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--jobs 8] [--out FILE]

For each seed: the cell's pool, one warm-up job, then `--jobs` jobs of
the window's own job function, with the run's seeded sample of them
(the helpers of harness/loop.py that run.py's window uses);
after every seed has run, the program's state goes and the reference
compares each seed's sample. Prints one JSON line a seed.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench.harness import check, guard, loop, spec  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--jobs", type=int, default=None)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    import torch

    cell = spec.load_cell(args.workload)
    guard.require_cards(cell.chips)
    t = cell.traffic
    jobs = args.jobs or t["pool"]
    fam = cell.family().build(cell, "cuda")
    kept = {}
    for seed in args.seeds:
        pool = loop.make_pool(cell, seed, "cuda")
        loop.warm_up(fam, pool)
        window, sample = loop.Window(), loop.Reservoir(t["sample_jobs"], seed)
        loop.run_jobs(fam, pool, window, sample, count=jobs)
        kept[seed] = (loop.sampled_outputs(fam, window, sample),
                      window.failed, window.seconds / max(1, jobs))
        del pool, sample
    del fam
    gc.collect()
    torch.cuda.empty_cache()
    lines = []
    for seed in args.seeds:
        samples, failed, per_job = kept[seed]
        t0 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed, "failed": failed,
                "job_s": per_job,
                "program": check.readings(cell, seed, samples, "cuda")}
        line["reference_s"] = time.perf_counter() - t0
        if seed in args.control_seeds:
            line["control"] = check.readings(cell, seed, samples, "cuda",
                                             rounding=t["control"])
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
