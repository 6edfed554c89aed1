"""Training: the train step, the loop with checkpoints and resume, and
eval. Counterpart of ``asltpu/train``."""

from asltpu_torch.train.loop import (  # noqa: F401
    FaultInjected,
    TrainState,
    create_train_state,
    make_eval_step,
    make_step_fn,
    make_train_step,
    train,
)
