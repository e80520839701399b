"""Built-in multi-process validation worker.

Port of `ns_tpu/cli/dist_selftest.py`. Run it through the launcher:

    python -m ns_tpu_torch.launch --nprocs 2 --platform cpu --selftest
    python -m ns_tpu_torch.launch --nprocs 1 --selftest      # on the card

Each rank joins the process group from the NS_TPU_* environment, then the
gang checks, across real process boundaries (gloo on the CPU, NCCL on the
card):

  1. device discovery      — world size and this rank's device
  2. halo exchange         — the exchange delivers the true neighbour edge
                             rows (parallel/halo.py)
  3. distributed spectral  — the sharded compact matmul-DFT rollout
                             (parallel/spectral_sharded.py: all_to_all
                             transposes) matches a single-device rollout
                             elementwise (float64, atol 1e-11)
  4. all-reduce            — the global sum agrees with the exact total
  5. per-rank sharded IO   — save_array_shards writes only this rank's
                             block; the coordinator reassembles the
                             global field and checks it

Prints `SELFTEST OK p{pid}` on success; any failure raises (a nonzero
exit, which the launcher passes on).
"""

from __future__ import annotations


def main() -> None:
    import glob
    import os
    import tempfile

    import numpy as np
    import torch

    from ns_tpu_torch.parallel import distributed as dist
    from ns_tpu_torch.parallel.collectives import all_reduce_sum
    from ns_tpu_torch.parallel.halo import exchange_halo_rows
    from ns_tpu_torch.parallel.mesh import Sharding
    from ns_tpu_torch.parallel.spectral_sharded import (
        make_sharded_compact_rollout)
    from ns_tpu_torch.solvers import spectral_periodic as sp

    device = dist.initialize_from_env()
    pid = dist.process_index()
    nproc = dist.process_count()
    backend = torch.distributed.get_backend()
    print(f"p{pid}: {nproc} processes, one device each, this one "
          f"{device} ({backend})", flush=True)
    mesh = dist.make_global_mesh({"x": nproc})
    assert mesh.mesh.numel() == nproc, (mesh, nproc)

    # -- 2. halo exchange across the process boundary ---------------------
    nx, ny = 8 * nproc, 16
    full = np.arange(nx * ny, dtype=np.float64).reshape(nx, ny)
    sharding = Sharding(mesh, ("x", None))
    lo, hi = dist.process_local_rows(nx, mesh, "x")
    garr = dist.global_array(sharding, full[lo:hi])
    block = exchange_halo_rows(garr.local, mesh, "x").cpu().numpy()
    want_below = np.zeros(ny) if lo == 0 else full[lo - 1]
    want_above = np.zeros(ny) if hi == nx else full[hi]
    np.testing.assert_array_equal(block[0], want_below)
    np.testing.assert_array_equal(block[-1], want_above)
    np.testing.assert_array_equal(block[1:-1], full[lo:hi])
    print(f"p{pid}: halo exchange across processes OK", flush=True)

    # -- 3. distributed compact spectral rollout vs single-device ---------
    cfg = sp.SpectralPeriodicConfig(nt=8, nx=8 * nproc, ny=8 * nproc,
                                    dt=0.005, nu=1e-3, dtype="float64",
                                    transform="matmul",
                                    matmul_precision="highest",
                                    compact_spectrum=True, dealias=True)
    w0 = sp.decaying_turbulence_vorticity(cfg, seed=3)
    carry0 = sp.init_from_vorticity(cfg, w0, device=device)
    w_hat_ref, _ = sp.rollout_final_compact(cfg, carry0)
    w_ref = sp.physical_from_carry(cfg, w_hat_ref).cpu().numpy()

    rollout, phys_sharding = make_sharded_compact_rollout(cfg, mesh)
    lo, hi = dist.process_local_rows(cfg.nx, mesh, "x")
    w_fin = rollout(dist.global_array(phys_sharding, w0[lo:hi]))
    for (idx, blk) in dist.local_shards(w_fin):
        r0 = idx[0][0]
        np.testing.assert_allclose(blk, w_ref[r0:r0 + blk.shape[0]],
                                   atol=1e-11)
    print(f"p{pid}: distributed matmul-DFT rollout matches local "
          f"single-device rollout at {cfg.nx}^2", flush=True)

    # -- 4. global all-reduce ----------------------------------------------
    total = float(all_reduce_sum(garr.local.sum(), mesh, "x"))
    assert total == full.sum(), total
    print(f"p{pid}: all-reduce OK", flush=True)

    # -- 5. per-rank sharded output ----------------------------------------
    out_dir = os.environ.get("NS_TPU_SELFTEST_DIR")
    if out_dir is None:
        coord = os.environ.get("NS_TPU_COORDINATOR", "x")
        out_dir = os.path.join(
            tempfile.gettempdir(),
            "ns_tpu_torch_selftest_" + coord.replace(":", "_")
            .replace("/", "_"))
    # a fixed dir may hold an earlier run's files: the coordinator clears
    # them before anyone writes, else assemble_shards rejects the set
    if dist.is_coordinator() and os.path.isdir(out_dir):
        for f in glob.glob(os.path.join(out_dir, "w_final.proc*.npz")):
            os.remove(f)
    dist.barrier("selftest_clean")
    dist.save_array_shards(out_dir, "w_final", w_fin)
    dist.barrier("selftest_io")
    if dist.is_coordinator():
        assembled = dist.assemble_shards(out_dir, "w_final")
        np.testing.assert_allclose(assembled, w_ref, atol=1e-11)
        print(f"p{pid}: per-rank shard files reassemble to the global "
              f"field ({out_dir})", flush=True)
    dist.barrier("selftest_done")
    dist.shutdown()
    print(f"SELFTEST OK p{pid}", flush=True)


if __name__ == "__main__":
    main()
