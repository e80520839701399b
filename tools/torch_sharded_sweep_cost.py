"""Where the sharded chorin_fd SOR sweep's time goes, on the card.

Run it as one rank of a gang (NCCL, a world of 1 on one card):

    python -m ns_tpu_torch.launch --nprocs 1 --platform cuda -- \\
        python tools/torch_sharded_sweep_cost.py

Prints one line, "SWEEP " and a JSON object: the host microseconds a call
(a loop of 500 calls ended by a synchronize; each loop is host-bound) of
the pieces of one sweep of `parallel/chorin_fd_sharded.py` at 1024^2
float32 (a column halo exchange, the gate's max-reduction through the
counted `all_reduce_max` and through a bare `dist.all_reduce`, the local
max), of the single-device plain sweep (`ops/poisson.py::redblack_sweep`)
with and without its per-sweep host read, and the sharded explicit step
at nit 200 in ms.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.distributed as tdist

from ns_tpu_torch.cli.run_solver import cavity_bcs
from ns_tpu_torch.ops import poisson
from ns_tpu_torch.parallel import chorin_fd_sharded
from ns_tpu_torch.parallel import distributed as dist
from ns_tpu_torch.parallel.collectives import all_reduce_max
from ns_tpu_torch.parallel.halo import exchange_halo_cols
from ns_tpu_torch.solvers import chorin_fd

N = 1024


def host_us(fn, n: int = 500) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main():
    dev = dist.initialize_from_env()
    mesh = dist.make_global_mesh({"x": dist.process_count()})
    gen = torch.Generator().manual_seed(0)
    p, c = (torch.rand((N, N), generator=gen).to(dev) for _ in range(2))
    masks = poisson.checkerboard(N, N, device=dev)
    scalar = torch.zeros((), device=dev)
    out = {
        "halo_exchange_us": host_us(
            lambda: exchange_halo_cols(p, mesh, "x")),
        "all_reduce_max_us": host_us(
            lambda: all_reduce_max(p.max(), mesh, "x")),
        "bare_nccl_all_reduce_us": host_us(
            lambda: tdist.all_reduce(scalar, op=tdist.ReduceOp.MAX)),
        "local_max_us": host_us(lambda: p.max()),
        "plain_sweep_us": host_us(
            lambda: poisson.redblack_sweep(p, c, 0.01, 0.01, 1.25, masks)),
        "plain_sweep_and_read_us": host_us(lambda: float(
            (poisson.redblack_sweep(p, c, 0.01, 0.01, 1.25, masks)
             - p).abs().max())),
    }
    cfg = chorin_fd.ChorinFDConfig(nt=1, nit=200, nx=N, ny=N, dt=1e-5,
                                   nu=0.01, method="explicit")
    bcs = cavity_bcs(cfg.dx, cfg.dy)
    z = np.zeros((N, N))
    s0 = chorin_fd.init_state(cfg, z, z, z, *bcs, device=dev)
    step, _ = chorin_fd_sharded.make_sharded_step(cfg, *bcs, mesh)
    out["sharded_step_ms"] = host_us(lambda: step(s0), 5) / 1e3
    out["device"] = torch.cuda.get_device_name(dev)
    dist.barrier("sweep_cost_done")
    dist.shutdown()
    print("SWEEP " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
