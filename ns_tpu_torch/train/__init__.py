from ns_tpu_torch.train.metrics import AverageMeter, mean_squared_error
from ns_tpu_torch.train.checkpoint import save_checkpoint, load_checkpoint
from ns_tpu_torch.train.trainer import TrainConfig, Trainer
