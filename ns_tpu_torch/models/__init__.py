from ns_tpu_torch.models.node import odeint, odeint_checkpoint
from ns_tpu_torch.models.basis import BasisODE, BasisODE2, BasisGRU
from ns_tpu_torch.models.gru import FullFieldGRU
