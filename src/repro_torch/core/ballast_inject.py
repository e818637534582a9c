"""In-step Firefly ballast (paper Sec. IV-D): secondary matrix work tied
to the training loss, and how many FLOPs of it fill a power trough.

``attach_ballast`` adds ``1e-30 * checksum`` of a chain of bf16 GEMMs
(``ballast_chain``) to the loss: materially zero (below an ulp of any
realistic loss) and with no gradient through the chain, so training is
unchanged while the card does the extra work inside the step.  The chain
is plain ``torch.matmul`` on the loss's device, as the reference's is a
plain XLA matmul chain outside any kernel of its own; it is launched on
every call (nothing is cached), and the checksum's read keeps it from
being skipped.

``ballast_gflops_for_floor`` sizes the burn that holds an observed
aggregate trace at a power floor (the control plane's power-cap rung);
``ballast_gflops_for_cell`` sizes the per-step burn from a dry-run
artifact's exposed collective time.  Both are host arithmetic on the
simulated chip's constants (``core/hardware.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hardware import DEFAULT_HW, Hardware


def ballast_iters(gflops: float, d: int = 256) -> int:
    """Products in a chain of ``gflops``: ``2 d^3`` FLOPs each, at least
    one."""
    return max(int(gflops * 1e9 / (2.0 * d * d * d)), 1)


def ballast_chain(gflops: float, d: int = 256, dtype=torch.bfloat16,
                  device=None) -> torch.Tensor:
    """``ballast_iters(gflops, d)`` products ``c <- c @ b`` of ``[d x d]``
    ``dtype`` matrices, each rounded to ``dtype``, from ``a = (1 + I) *
    0.01`` with ``b = 0.999 I``: the f32 sum of the result, a 0-d tensor
    on ``device`` (None: the CPU).  0.999 rounds to 1 in bf16, so every
    product is exact whatever the GEMM accumulates in, and the checksum is
    the reference's (whose dot accumulates in f32)."""
    eye = torch.eye(d, dtype=dtype, device=device)
    c = (torch.ones((d, d), dtype=dtype, device=device) + eye) * 0.01
    b = eye * 0.999
    for _ in range(ballast_iters(gflops, d)):
        c = torch.matmul(c, b)
    return c.float().sum()


def attach_ballast(loss: torch.Tensor, gflops: float,
                   d: int = 256) -> torch.Tensor:
    """``loss + 1e-30 * checksum`` of a ``gflops`` chain on the loss's
    device: equal to ``loss`` in value, carrying the chain's work.  No
    gradient flows through the chain."""
    if gflops <= 0:
        return loss
    with torch.no_grad():
        checksum = ballast_chain(gflops, d, device=loss.device)
    return loss + 1e-30 * checksum.to(loss.dtype)


def ballast_gflops_for_cell(cell: dict, hw: Hardware = DEFAULT_HW,
                            floor_frac: float = 0.9,
                            overlap: float = 0.0) -> float:
    """Size the per-step ballast from a dry-run artifact: enough FLOPs to
    hold the matrix units at ``floor_frac`` of peak for the exposed-comm
    window."""
    coll_bytes = sum(cell.get("collectives", {}).values())
    t_comm = coll_bytes / (hw.chip.ici_bw_per_link * hw.chip.ici_links)
    t_exposed = t_comm * (1.0 - overlap)
    return floor_frac * hw.chip.peak_flops_bf16 * t_exposed / 1e9


def ballast_gflops_for_floor(w, dt: float, floor_w: float, n_chips: int,
                             hw: Hardware = DEFAULT_HW,
                             burn_frac: float = 0.9) -> float:
    """Size the ballast that holds an observed aggregate trace at a power
    floor: total GFLOPs to burn the trough deficit (energy below
    ``floor_w`` over the trace), converted at the chip's FLOP-per-joule
    at TDP and derated by ``burn_frac`` (ballast GEMMs don't hit peak).
    The power-cap rung clamps peaks; this ballast fills the troughs so
    the clamp band holds from below."""
    del n_chips
    deficit_j = float(np.clip(floor_w - np.asarray(w, np.float64),
                              0.0, None).sum() * dt)
    flop_per_j = hw.chip.peak_flops_bf16 / hw.chip.tdp_w
    return burn_frac * flop_per_j * deficit_j / 1e9
