"""Checkpoints of host trees (``checkpoint``) and resumable Study streams
(``resume``)."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, load_pytree_numpy,
                                         restore_pytree, save_pytree)
from repro_torch.ckpt.resume import ResumeError, SweepCheckpoint

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "load_pytree_numpy", "ResumeError", "SweepCheckpoint"]
