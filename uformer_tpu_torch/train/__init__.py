"""Training: losses, lr schedules and the train/eval steps."""

from uformer_tpu_torch.train.losses import (  # noqa: F401
    charbonnier_loss,
    tv_loss,
)
from uformer_tpu_torch.train.schedules import (  # noqa: F401
    step_lr_schedule,
    warmup_cosine_schedule,
)
from uformer_tpu_torch.train.train_step import (  # noqa: F401
    TrainState,
    blocks_without_backward_kernel,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
