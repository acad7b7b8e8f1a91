"""LM training (counterpart of ``repro/train``): optimizers, the train
step, checkpoints, the gradient codec and elastic planning."""
from .optim import OptConfig, opt_init, opt_update
from .step import TrainConfig, init_train_state, init_train_state_shapes, make_train_step

__all__ = [
    "OptConfig", "TrainConfig", "init_train_state", "init_train_state_shapes",
    "make_train_step", "opt_init", "opt_update",
]
