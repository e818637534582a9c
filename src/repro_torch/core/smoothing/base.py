"""Mitigation interface: a transform on batches of sampled power
waveforms.

A mitigation is a frozen dataclass.  Its continuous fields are the
parameters a study sweeps; its ``STATIC_FIELDS`` fix the computation
(windows, hardware, the relaxation switch).  Mitigations of one
*structure* (same class and static fields, see ``structure``) batch
together: ``type(m).apply_batch(mits, w, dt)`` stacks their parameters
into per-row float32 tensors and transforms ``w`` ``[B, n]``, one row
per mitigation, in one pass.

``apply_batch`` consumes the power the load *wants* to draw and returns
the power the upstream level *sees*, plus an aux dict of per-row tensors.
``Stack`` composes stages in load->utility order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Protocol, Sequence, Tuple

import torch

# the ROADMAP queue A item that brings each relaxation / mitigation the
# port does not run yet
RELAXED_NOT_PORTED = ("smooth_tau > 0 (the differentiable design path) is "
                      "not ported yet: ROADMAP queue A, the design slice")


class Mitigation(Protocol):
    STATIC_FIELDS: Tuple[str, ...]

    @classmethod
    def apply_batch(cls, mits: Sequence, w: torch.Tensor, dt: float
                    ) -> Tuple[torch.Tensor, Dict]:
        ...


def structure(mit) -> Tuple:
    """The batching key of a mitigation: class and static fields (for a
    ``Stack``, the structures of its stages)."""
    if isinstance(mit, Stack):
        return ("Stack",) + tuple(structure(s) for s in mit.stages)
    fields = getattr(type(mit), "STATIC_FIELDS", None)
    if fields is None:
        raise NotImplementedError(
            f"{type(mit).__name__} is not ported yet (ROADMAP queue A); "
            "the port runs GpuPowerSmoothing, RackBattery, "
            "TelemetryBackstop and Stack")
    return (type(mit).__name__,) + tuple(getattr(mit, f) for f in fields)


def apply_mitigation(mits: Sequence, w: torch.Tensor, dt: float
                     ) -> Tuple[torch.Tensor, Dict]:
    """Apply one structure group of mitigations row-wise to ``w``
    ``[len(mits), n]``."""
    mits = list(mits)
    keys = {structure(m) for m in mits}
    if len(keys) != 1:
        raise ValueError(f"mitigations of one batch must share a structure, "
                         f"got {sorted(map(str, keys))}")
    if w.dim() != 2 or w.shape[0] != len(mits):
        raise ValueError(f"w must be [{len(mits)}, n], got {tuple(w.shape)}")
    return type(mits[0]).apply_batch(mits, w, dt)


def stack_params(mits: Sequence, names: Sequence[str], device
                 ) -> Dict[str, torch.Tensor]:
    """Per-row float32 parameter tensors ``[B]`` of the named fields."""
    return {name: torch.tensor([float(getattr(m, name)) for m in mits],
                               dtype=torch.float32, device=device)
            for name in names}


def mean64(w: torch.Tensor) -> torch.Tensor:
    """Row means ``[B]`` of ``w`` ``[B, n]``, summed in float64 and
    rounded to float32: the same value on every device, whatever order
    its reduction kernels take."""
    return w.to(torch.float64).mean(-1).to(torch.float32)


def energy_overhead(w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """(E_out - E_in) / E_in per row: the paper's 'wasted energy' metric.
    Energies are summed in float64, so the small difference of two large
    sums keeps its digits."""
    e_in = w_in.to(torch.float64).sum(-1)
    e_out = w_out.to(torch.float64).sum(-1)
    return ((e_out - e_in) / torch.clamp(e_in, min=1e-12)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Stack:
    """Stages applied in load->utility order; aux per stage under
    ``"<i>:<ClassName>"``."""
    stages: Tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))

    @classmethod
    def apply_batch(cls, mits: Sequence["Stack"], w: torch.Tensor, dt: float
                    ) -> Tuple[torch.Tensor, Dict]:
        aux_all: Dict = {}
        for i, stage in enumerate(mits[0].stages):
            w, aux = apply_mitigation([m.stages[i] for m in mits], w, dt)
            aux_all[f"{i}:{type(stage).__name__}"] = aux
        return w, aux_all
