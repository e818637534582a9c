"""Training (reference: ``repro/train``): the model zoo's train step with
AdamW, microbatches and the in-step ballast, its int8 data-parallel form
(``trainer.make_dp_compressed_train_step``), and the regression step
that trains the serve path's warm-start predictor."""
from repro_torch.train.optimizer import (adamw_update, clip_by_global_norm,
                                         init_opt_state, lr_schedule)
from repro_torch.train.trainer import (TrainState, init_train_state,
                                       make_regression_train_step,
                                       make_train_step)

__all__ = ["adamw_update", "clip_by_global_norm", "init_opt_state",
           "lr_schedule", "TrainState", "make_train_step",
           "init_train_state", "make_regression_train_step"]
