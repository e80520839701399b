"""Serving: a checkpoint directory -> a rollout service on the card.

Port of `ns_tpu/serve/`: `InferenceEngine` loads a checkpoint written by
the JAX package's Trainer or EnsembleTrainer (or by the port's
`train/checkpoint.py`), rebuilds the model from its embedded config and
serves any-horizon extrapolation; `SolverEngine` and `SolverEngine3D`
serve the periodic solvers behind the same contract (the oracle);
`serve.server` puts any of them behind the HTTP protocol (with request
coalescing for surrogates, `serve.batching`), and `ServeClient` speaks it
(`python -m ns_tpu_torch.cli.serve` starts a server).

The classical-solver runtime (CUDA-graph-captured rollouts and exported
programs) is `ns_tpu_torch.runtime`.
"""

from ns_tpu_torch.serve.client import ServeClient, ServeError
from ns_tpu_torch.serve.engine import InferenceEngine
from ns_tpu_torch.serve.solver import SolverEngine, SolverEngine3D

__all__ = ["InferenceEngine", "SolverEngine", "SolverEngine3D",
           "ServeClient", "ServeError"]
