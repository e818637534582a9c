"""Mitigations: GPU power floor, Firefly, rack battery, telemetry backstop,
their combination and the ``Stack`` combinator."""
from repro_torch.core.smoothing.backstop import TelemetryBackstop
from repro_torch.core.smoothing.base import Stack, apply_mitigation
from repro_torch.core.smoothing.battery import RackBattery
from repro_torch.core.smoothing.combined import (CombinedMitigation,
                                                 design_mitigation)
from repro_torch.core.smoothing.firefly import Firefly
from repro_torch.core.smoothing.gpu_floor import GpuPowerSmoothing

__all__ = ["GpuPowerSmoothing", "Firefly", "RackBattery", "TelemetryBackstop",
           "CombinedMitigation", "Stack", "apply_mitigation",
           "design_mitigation"]
