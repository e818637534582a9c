"""Waveform synthesis, mitigations, specs, the batched engine and the
Study surface; and the in-step ballast of the training path."""
from repro_torch.core.ballast_inject import (attach_ballast,
                                             ballast_gflops_for_cell)

__all__ = ["attach_ballast", "ballast_gflops_for_cell"]
