"""Training steps (reference: ``repro/train``).  Only the regression step
that trains the serve path's warm-start predictor is ported; the model
zoo's training loop, loss and AdamW schedule come with the rest of the
model zoo (ROADMAP queue A, the model zoo)."""
from repro_torch.train.trainer import make_regression_train_step

__all__ = ["make_regression_train_step"]
