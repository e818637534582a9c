"""Kernel G: the ballast GEMM burner (``ballast.py``) and its FLOP-targeted
entry point (``ops.py``)."""
from repro_torch.kernels.ballast.ops import ballast_burn, ballast_flops

__all__ = ["ballast_burn", "ballast_flops"]
