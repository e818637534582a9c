"""repro_torch: the PyTorch/CUDA port of the power-stabilization system.

It mirrors the layout of the JAX reference package ``repro`` and runs its
hot loops as hand-written CUDA kernels on an NVIDIA Hopper card.  It
imports torch and numpy only.  ``repro_torch.api`` is the public surface.
"""
