"""Build the port's configuration objects from plain field dicts.

``from_reference_fields(kind, fields)`` takes the numbers, strings,
tuples and numpy arrays of one object, as ``dataclasses.asdict`` gives
them for the reference package's dataclasses (nested dataclasses as
nested dicts), and returns the port's object of that kind.  A ``Stack``
is ``{"stages": [(kind, fields), ...]}``.  Nothing of the reference
package is imported: the dicts are the interface.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from repro_torch.core.hardware import (ChipSpec, DatacenterTopology, Hardware,
                                       ServerSpec)
from repro_torch.core.phases import IterationTimeline, Phase
from repro_torch.core.smoothing import (GpuPowerSmoothing, RackBattery, Stack,
                                        TelemetryBackstop)
from repro_torch.core.spec import (FrequencyDomainSpec, TimeDomainSpec,
                                   UtilitySpec)
from repro_torch.core.waveform import WaveformConfig

KINDS = ("WaveformConfig", "IterationTimeline", "Phase", "Hardware",
         "UtilitySpec", "GpuPowerSmoothing", "RackBattery",
         "TelemetryBackstop", "Stack")


def _plain(v):
    """numpy scalars and arrays -> Python numbers and tuples."""
    if isinstance(v, np.ndarray):
        return tuple(_plain(x) for x in v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    return v


def _fields(d: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: _plain(v) for k, v in d.items()}


def _hardware(d: Mapping) -> Hardware:
    return Hardware(chip=ChipSpec(**_fields(d["chip"])),
                    server=ServerSpec(**_fields(d["server"])),
                    topo=DatacenterTopology(**_fields(d["topo"])))


def _phase(d: Mapping) -> Phase:
    return Phase(**_fields(d))


def from_reference_fields(kind: str, fields: Mapping[str, Any]):
    """The port's ``kind`` object from a plain field dict."""
    if kind == "Phase":
        return _phase(fields)
    if kind == "IterationTimeline":
        return IterationTimeline(tuple(_phase(p) for p in fields["phases"]))
    if kind == "WaveformConfig":
        f = _fields({k: v for k, v in fields.items() if k != "ckpt_phase"})
        ck = fields.get("ckpt_phase")
        return WaveformConfig(**f, ckpt_phase=None if ck is None
                              else _phase(ck))
    if kind == "Hardware":
        return _hardware(fields)
    if kind == "UtilitySpec":
        return UtilitySpec(name=fields["name"],
                           time=TimeDomainSpec(**_fields(fields["time"])),
                           freq=FrequencyDomainSpec(**_fields(fields["freq"])))
    if kind == "GpuPowerSmoothing":
        f = _fields({k: v for k, v in fields.items() if k != "hw"})
        return GpuPowerSmoothing(**f, hw=_hardware(fields["hw"]))
    if kind == "RackBattery":
        return RackBattery(**_fields(fields))
    if kind == "TelemetryBackstop":
        return TelemetryBackstop(**_fields(fields))
    if kind == "Stack":
        return Stack(tuple(from_reference_fields(k, f)
                           for k, f in fields["stages"]))
    raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
