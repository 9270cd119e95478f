"""repro_torch.training — the train and eval steps (the reference's
``training``)."""
from .steps import (TrainState, init_train_state, make_eval_step,
                    make_train_step)

__all__ = ["TrainState", "make_train_step", "make_eval_step",
           "init_train_state"]
