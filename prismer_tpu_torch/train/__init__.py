"""Training: schedules, freeze partitions + AdamW over fp32 masters, the
train state, the jit-free train / eval steps, checkpoints and metric logs."""

from prismer_tpu_torch.train.state import TrainState
from prismer_tpu_torch.train.step import (build_eval_loss_step,
                                          build_train_step)

__all__ = ["TrainState", "build_train_step", "build_eval_loss_step"]
