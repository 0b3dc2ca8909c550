"""Training: the train/eval steps, the flat optimizers, LR schedules, the
train state, checkpoints and Path B's ``Trainer``
(:mod:`mmr_tpu_torch.train.engine`)."""

from mmr_tpu_torch.train.optim import build_optimizer  # noqa: F401
from mmr_tpu_torch.train.schedules import build_lr_schedule  # noqa: F401
from mmr_tpu_torch.train.state import TrainState  # noqa: F401
from mmr_tpu_torch.train.steps import make_eval_step, make_train_step  # noqa: F401
