"""Scale-out of the port on torch.distributed: one rank per process and
one device per rank (NCCL on CUDA, gloo on the CPU).

  - `mesh.py`: named DeviceMeshes (`make_mesh`, `MESH_PRESETS`),
    shardings and rank-local global arrays;
  - `collectives.py`: the counted all_to_all, all-reduce and edge
    permutes the solvers use;
  - `halo.py`: 1-cell halo exchange for sharded FD stencils;
  - `distributed.py`: bootstrap from the NS_TPU_* variables, global
    arrays, per-rank shard files;
  - `ensemble.py`: ensembles of independent rollouts;
  - `spectral_sharded.py`, `direct_fd_sharded.py`: the sharded periodic
    (distributed FFT and compact matmul-DFT) and direct_fd solvers.

The launcher is `python -m ns_tpu_torch.launch`.
"""

from ns_tpu_torch.parallel.mesh import make_mesh, MESH_PRESETS
from ns_tpu_torch.parallel.halo import exchange_halo_rows
from ns_tpu_torch.parallel import distributed
