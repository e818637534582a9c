"""Mitigations: GPU power floor, rack battery, telemetry backstop and the
``Stack`` combinator."""
from repro_torch.core.smoothing.backstop import TelemetryBackstop
from repro_torch.core.smoothing.base import Stack, apply_mitigation
from repro_torch.core.smoothing.battery import RackBattery
from repro_torch.core.smoothing.gpu_floor import GpuPowerSmoothing

__all__ = ["GpuPowerSmoothing", "RackBattery", "TelemetryBackstop", "Stack",
           "apply_mitigation"]
