"""Deployment runtime of the port (ns_tpu_torch/runtime/engine.py): solver
rollouts built once and replayed from CUDA graphs, and rollouts exported
with torch.export and loaded without the solver code."""

from ns_tpu_torch.runtime.engine import (FDRolloutEngine, Rollout3DEngine,
                                         RolloutEngine, export_fd_rollout,
                                         export_rollout, export_rollout3d,
                                         load_fd_rollout_artifact,
                                         load_rollout_artifact,
                                         load_rollout3d_artifact)

__all__ = ["RolloutEngine", "FDRolloutEngine", "Rollout3DEngine",
           "export_rollout", "export_fd_rollout", "export_rollout3d",
           "load_rollout_artifact", "load_fd_rollout_artifact",
           "load_rollout3d_artifact"]
