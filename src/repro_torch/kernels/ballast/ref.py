"""The oracle of the ballast burner: ``n_iter`` steps of C <- (C B) decay
from C = a, in float32 (the reference's ``ballast_ref``) or, with
``dtype=torch.float64``, in float64."""
from __future__ import annotations

import torch


def ballast_ref(a, b, n_iter: int, decay: float = 0.999,
                dtype=torch.float32) -> torch.Tensor:
    """a ``[M, K]``, b ``[K, N]`` -> C ``[M, N]`` in ``dtype``."""
    c = a.to(dtype)
    b = b.to(dtype)
    for _ in range(n_iter):
        c = (c @ b) * decay
    return c
