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
A mitigation that consumes randomness (telemetry noise) takes per-row
PRNG keys ``keys`` ``[B, 2]`` (``core/prng.py``) as a keyword of its
``apply_batch``; ``apply_mitigation`` passes them to such classes only.
``Stack`` composes stages in load->utility order, stage ``i`` drawing
from ``fold_in(key, i)``.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device

class Mitigation(Protocol):
    STATIC_FIELDS: Tuple[str, ...]

    @classmethod
    def apply_batch(cls, mits: Sequence, w: torch.Tensor, dt: float
                    ) -> Tuple[torch.Tensor, Dict]:
        ...


def structure(mit) -> Tuple:
    """The batching key of a mitigation: class and static fields (for a
    ``Stack``, the structures of its stages; for a mitigation with
    ``NESTED_FIELDS``, the structures of those nested mitigations)."""
    if isinstance(mit, Stack):
        return ("Stack",) + tuple(structure(s) for s in mit.stages)
    fields = getattr(type(mit), "STATIC_FIELDS", None)
    if fields is None:
        raise NotImplementedError(
            f"{type(mit).__name__} is not a mitigation of the port; it runs "
            "GpuPowerSmoothing, Firefly, RackBattery, TelemetryBackstop, "
            "CombinedMitigation and Stack")
    nested = getattr(type(mit), "NESTED_FIELDS", ())
    return ((type(mit).__name__,) + tuple(getattr(mit, f) for f in fields)
            + tuple(structure(getattr(mit, f)) for f in nested))


def accepts_keys(mit) -> bool:
    """True when the mitigation's class consumes randomness: its
    ``apply_batch`` takes per-row ``keys``."""
    return "keys" in inspect.signature(type(mit).apply_batch).parameters


def apply_mitigation(mits: Sequence, w: torch.Tensor, dt: float,
                     keys: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """Apply one structure group of mitigations row-wise to ``w``
    ``[len(mits), n]``; ``keys`` ``[len(mits), 2]`` reach the class only
    if it takes them."""
    mits = list(mits)
    structs = {structure(m) for m in mits}
    if len(structs) != 1:
        raise ValueError(f"mitigations of one batch must share a structure, "
                         f"got {sorted(map(str, structs))}")
    if w.dim() != 2 or w.shape[0] != len(mits):
        raise ValueError(f"w must be [{len(mits)}, n], got {tuple(w.shape)}")
    if keys is not None and accepts_keys(mits[0]):
        return type(mits[0]).apply_batch(mits, w, dt, keys=keys)
    return type(mits[0]).apply_batch(mits, w, dt)


def stack_params(mits: Sequence, names: Sequence[str], device
                 ) -> Dict[str, torch.Tensor]:
    """Per-row float32 parameter tensors ``[B]`` of the named fields.  A
    field may hold a 0-d tensor (the design's iterate): its rows are then
    stacked with ordinary torch ops, so gradients reach it."""
    out = {}
    for name in names:
        vals = [getattr(m, name) for m in mits]
        if any(isinstance(v, torch.Tensor) for v in vals):
            out[name] = torch.stack([torch.as_tensor(
                v, dtype=torch.float32, device=device).reshape(())
                for v in vals])
        else:
            out[name] = torch.tensor([float(v) for v in vals],
                                     dtype=torch.float32, device=device)
    return out


def materialize_aux(aux: Dict, row: int = 0) -> Dict:
    """Row ``row`` of an aux tree of per-row tensors as host values: a
    python int or float for a scalar, a numpy array otherwise."""
    out: Dict = {}
    for k, v in aux.items():
        if isinstance(v, dict):
            out[k] = materialize_aux(v, row)
        elif isinstance(v, torch.Tensor):
            a = v[row].detach().cpu().numpy()
            if a.ndim == 0:
                out[k] = int(a) if a.dtype.kind in "iub" else float(a)
            else:
                out[k] = a
        else:
            out[k] = v
    return out


def np_apply(mit, w, dt: float, key=None, device=None
             ) -> Tuple[np.ndarray, Dict]:
    """One mitigation on one trace ``w`` ``[n]`` (numpy in, numpy out),
    on ``device`` (None: the card): ``(out [n], aux)`` with host aux
    values.  ``key`` (a key or an int seed, ``prng.as_key``) feeds a
    mitigation that draws noise."""
    dev = resolve_device(device)
    row = torch.as_tensor(np.asarray(w, np.float32), device=dev)[None]
    keys = None if key is None else prng.as_key(key)[None].to(dev)
    out, aux = apply_mitigation([mit], row, dt, keys)
    return out[0].cpu().numpy(), materialize_aux(aux)


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
    def apply_batch(cls, mits: Sequence["Stack"], w: torch.Tensor, dt: float,
                    keys: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        aux_all: Dict = {}
        for i, stage in enumerate(mits[0].stages):
            k = None if keys is None else prng.fold_in(keys, i)
            w, aux = apply_mitigation([m.stages[i] for m in mits], w, dt, k)
            aux_all[f"{i}:{type(stage).__name__}"] = aux
        return w, aux_all
