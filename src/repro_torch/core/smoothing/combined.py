"""The paper's proposed combination (Sec. IV-D): GPU-level smoothing for
ramps and corner cases, rack-level storage for the dynamic range.

``CombinedMitigation`` runs the GPU floor (kernel B) on the per-chip mean
waveform ``w / n_chips``, re-aggregates, and runs the battery (kernel C)
on the aggregate.  Its nested ``gpu`` and ``battery`` fix its batching
structure (``base.structure``); ``n_chips`` is a per-row parameter.

``design_mitigation`` is the spec -> configuration solver over
``engine.design`` (the grid search by default, as in the reference, or
the gradient solvers), confirming its winner with one ``apply_batch`` row
for the exact aux.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.smoothing.base import (energy_overhead,
                                             materialize_aux, stack_params)
from repro_torch.core.smoothing.battery import RackBattery
from repro_torch.core.smoothing.gpu_floor import GpuPowerSmoothing
from repro_torch.core.spec import UtilitySpec
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CombinedMitigation:
    gpu: GpuPowerSmoothing
    battery: RackBattery
    n_chips: int = 1      # the gpu stage runs per chip; the battery on the
                          # aggregate

    STATIC_FIELDS = ()
    NESTED_FIELDS = ("gpu", "battery")

    @classmethod
    def apply_batch(cls, mits: Sequence["CombinedMitigation"],
                    w: torch.Tensor, dt: float) -> Tuple[torch.Tensor, Dict]:
        w = w.to(torch.float32)
        chips = stack_params(mits, ("n_chips",), w.device)["n_chips"][:, None]
        smoothed, aux_g = GpuPowerSmoothing.apply_batch(
            [m.gpu for m in mits], w / chips, dt)
        out, aux_b = RackBattery.apply_batch(
            [m.battery for m in mits], smoothed * chips, dt)
        return out, {"gpu": aux_g, "battery": aux_b,
                     "energy_overhead": energy_overhead(w, out)}


def design_mitigation(spec: UtilitySpec, w, dt: float, n_chips: int,
                      hw: Hardware = DEFAULT_HW, period_hint_s: float = 2.0,
                      method: str = "grid", device=None,
                      **design_kwargs) -> Optional[Dict]:
    """The smallest-overhead (MPF, battery) pair that passes ``spec`` on
    the trace ``w``, by ``engine.design`` (``method="grid"``: the coarse
    candidate grid in one batch, the first passing configuration in (MPF,
    capacity) order; ``"gradient"``, ``"hybrid"`` and ``"warmstart"``: the
    gradient solvers, their keywords passed through).  The winner is applied
    once more as one row (``CombinedMitigation``, or the battery alone)
    for its exact aux, under ``"aux"``.  Runs on ``device`` (None: the
    card)."""
    from repro_torch.core.engine import design  # engine imports smoothing

    sol = design(spec, w, dt, n_chips, method=method, hw=hw,
                 period_hint_s=period_hint_s, device=device, **design_kwargs)
    if sol is None:
        return None
    gpu, bat = sol["device_mitigation"], sol["rack_mitigation"]
    row = torch.as_tensor(np.asarray(w, np.float32),
                          device=resolve_device(device))[None]
    if gpu and bat:
        _, aux = CombinedMitigation.apply_batch(
            [CombinedMitigation(gpu, bat, n_chips)], row, dt)
    elif bat:
        _, aux = RackBattery.apply_batch([bat], row, dt)
    else:
        aux = None
    sol["aux"] = {} if aux is None else materialize_aux(aux)
    return sol
