"""Serving: a checkpoint directory -> a rollout service on the card.

Port of `ns_tpu/serve/`: `InferenceEngine` loads a checkpoint written by
the JAX package's Trainer or EnsembleTrainer (or by the port's
`train/checkpoint.py`), rebuilds the model from its embedded config and
serves any-horizon extrapolation. The HTTP server, the client and the
solver oracle are not ported yet.
"""

from ns_tpu_torch.serve.engine import InferenceEngine

__all__ = ["InferenceEngine"]
