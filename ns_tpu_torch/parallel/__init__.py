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
    (distributed FFT and compact matmul-DFT) and direct_fd solvers;
  - `chorin_fd_sharded.py`: chorin_fd on column shards (halo exchange,
    the all-reduce gated red-black SOR, the distributed DST solve);
  - `chorin_spectral_sharded.py`: the corrected Chebyshev solver on column
    shards (all_gather y-contractions);
  - `spectral3d_sharded.py`: the 3D compact spectral solver on x pencils
    (one all_to_all a 3D transform), with an optional ensemble axis.

Data-parallel training lives with the trainer (`train/trainer.py`,
`TrainConfig.dp`) and the sharded ensemble trainer with the ensembles
(`train/ensemble.py::ensemble_mesh`).

The launcher is `python -m ns_tpu_torch.launch`.
"""

from ns_tpu_torch.parallel.mesh import make_mesh, MESH_PRESETS
from ns_tpu_torch.parallel.halo import exchange_halo_rows
from ns_tpu_torch.parallel import distributed
from ns_tpu_torch.parallel import (chorin_fd_sharded,
                                   chorin_spectral_sharded,
                                   spectral3d_sharded)
