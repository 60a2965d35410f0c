from repro_torch.train.state import TrainState
from repro_torch.train.step import (make_dmd_step, make_train_step,
                                    resolve_grad_accum)
from repro_torch.train.loop import Trainer

__all__ = ["TrainState", "make_train_step", "make_dmd_step",
           "resolve_grad_accum", "Trainer"]
