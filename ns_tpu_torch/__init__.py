"""ns_tpu_torch: the PyTorch + CUDA port of ns_tpu for NVIDIA Hopper (H100).

It sits beside the JAX package `ns_tpu`, which stays the reference, and
mirrors its module names. Plain tensor code is PyTorch; every Pallas TPU
kernel on a ported path is a hand-written CUDA kernel for sm_90a under
`csrc/`, built with nvcc at first use (`ops/kernels/_build.py`) and bound
as an operator of `torch.ops.ns_tpu` (`ops/kernels/library.py`): a kernel
wrapper's operator runs its plain torch twin only on a CPU tensor; on a
CUDA tensor it launches the kernel or raises.

Ported so far: the FD cavity pipeline (core BCs and state, the pressure
solvers, the direct_fd and chorin_fd solvers), the 2D periodic solver and
its differentiable rollouts, the 3D periodic pseudospectral DNS
(`solvers/spectral3d.py` with the fused transform kernels), the Chebyshev
family (`solvers/chorin_spectral.py`, `ops/parity.py`, a copy of
`ops/cheb.py`), the divergence guard and the chunked progress rollout
(`utils/`), with their CLI; the 2D surrogate models (`models/`: the basis
families, the full-field GRU, FNO2D with both spectral engines, FNOPsi,
the vorticity and projection maps), the checkpoint format and the weight
carry from JAX key paths (`train/checkpoint.py`), the training
configuration (`train/trainer.py`), the inference engine
(`serve/engine.py`) and `cli/evaluate.py`; training and the 3D
surrogates; the HTTP rollout service and the solver oracles (`serve/`,
`cli/serve.py`), the runtime engines replayed from CUDA graphs and their
`torch.export` artifacts (`runtime/`), and streaming rollouts to .npy
(`io/`, run_solver's `--stream-dir`); the public `core` and `io` names
(the reference npz, `spatial_coarsen`), the functional ensemble-training
API, the NaN tripwire, `shadow_check`, `utils/host` and `utils/profiling`;
scale-out on torch.distributed, one rank per process and one device per
rank (`parallel/`: meshes, halo exchange, counted collectives,
`distributed`, ensembles, the sharded periodic and direct_fd solvers;
`launch.py`, `cli/dist_selftest.py`, run_solver's `--dist`). This package
imports neither jax nor ns_tpu.
"""

__version__ = "0.1.0"
