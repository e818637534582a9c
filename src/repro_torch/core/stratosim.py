"""The per-scenario result record.  The serial ``simulate`` reference is
not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.spec import SpecReport


@dataclasses.dataclass
class SimResult:
    t: np.ndarray
    dc_raw: np.ndarray              # utility-point waveform, no mitigation
    dc_mitigated: np.ndarray
    chip_raw: np.ndarray
    chip_mitigated: Optional[np.ndarray]
    energy_overhead: float
    swing: Dict[str, float]
    swing_mitigated: Dict[str, float]
    bands: Dict[str, float]
    bands_mitigated: Dict[str, float]
    spec_report: Optional[SpecReport]
    aux: Dict
