"""The FLOP-targeted ballast burn on kernel G (the reference's
``kernels/ballast/ops.py``)."""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ballast.ballast import ballast


def ballast_flops(m: int, k: int, n: int, n_iter: int) -> float:
    return 2.0 * m * k * n * n_iter


def _tiles(generator: torch.Generator, m: int, k: int, n: int, dtype,
           device):
    """``a`` ~ N(0, 1)/sqrt(k), drawn on ``generator``'s device and moved
    to ``device``, and the near-orthogonal multiplier ``b`` = 0.999 I,
    which keeps the iterates bounded for any ``n_iter``."""
    a = torch.randn((m, k), generator=generator, device=generator.device)
    a = (a / math.sqrt(k)).to(device=device, dtype=dtype)
    b = (torch.eye(k, n, device=device) * 0.999).to(dtype)
    return a, b


def ballast_burn(generator: torch.Generator, *, gflops: float,
                 m: int = 1024, k: int = 256, n: int = 256,
                 device=None) -> torch.Tensor:
    """Burn about ``gflops`` of f32 GEMM work on ``device`` (``None``: the
    card; ``"cpu"`` runs the plain version) and return the checksum
    ``sum(C) 1e-9``, a 0-dim float32 tensor there."""
    dev = resolve_device(device)
    n_iter = max(int(gflops * 1e9 / (2.0 * m * k * n)), 1)
    a, b = _tiles(generator, m, k, n, torch.float32, dev)
    return torch.sum(ballast(a, b, n_iter)) * 1e-9
