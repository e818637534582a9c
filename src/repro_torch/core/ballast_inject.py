"""Firefly ballast sizing (paper Sec. IV-D): how many FLOPs of secondary
work fill a power trough.

``ballast_gflops_for_floor`` sizes the burn that holds an observed
aggregate trace at a power floor (the control plane's power-cap rung);
``ballast_gflops_for_cell`` sizes the per-step burn from a dry-run
artifact's exposed collective time.  Both are host arithmetic on the
simulated chip's constants (``core/hardware.py``).

The reference's in-graph ballast (``ballast_chain``, ``attach_ballast``:
a chain of GEMMs tied to the training loss) belongs to the training path
and is not ported yet (ROADMAP queue A, the model zoo).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hardware import DEFAULT_HW, Hardware


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
