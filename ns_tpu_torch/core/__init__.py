from ns_tpu_torch.core.bc import (BC, DirichletBoundaryCondition,
                                  NeumannBoundaryCondition, apply_bcs,
                                  dirichlet, neumann)
from ns_tpu_torch.core.state import FlowState
