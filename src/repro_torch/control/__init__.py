"""repro_torch.control: the grid-interactive control plane on the port.

A telemetry stream (live or replayed) flows through the online
sliding-Goertzel detector (chunked calls equal to the offline monitor bit
for bit), a per-bin hysteresis controller with slope-based early warning
decides an escalation level, and an intervention ladder (mitigation
re-design -> power cap + ballast floor -> job phase-stagger) is
dispatched back into the stream.

    from repro_torch import control
    from repro_torch.api import example_specs

    w = control.synthesize_ramp()                 # 9 Hz amplitude ramp
    log = control.watch_trace(
        w, 0.002, spec=example_specs(500.0)["moderate"], n_chips=512)
    print(log.timeline())                         # on the card
    log.summary()["detection_lead_s"]             # detected before breach

``device=None`` everywhere means the card; pass ``device="cpu"`` for the
kernels' plain versions.
"""
from repro_torch.control.controller import (ControlDecision, ControllerConfig,
                                            GridController)
from repro_torch.control.detector import DetectorFrame, OnlineGoertzelDetector
from repro_torch.control.interventions import (Intervention,
                                               InterventionLadder,
                                               power_cap_intervention,
                                               redesign_intervention,
                                               stagger_intervention)
from repro_torch.control.log import ControlLog, ControlRecord
from repro_torch.control.loop import ControlLoop, watch_trace
from repro_torch.control.stream import (ReplaySource, TelemetrySource,
                                        synthesize_ramp)

__all__ = [
    "ControlDecision", "ControllerConfig", "GridController",
    "DetectorFrame", "OnlineGoertzelDetector",
    "Intervention", "InterventionLadder", "redesign_intervention",
    "power_cap_intervention", "stagger_intervention",
    "ControlLog", "ControlRecord",
    "ControlLoop", "watch_trace",
    "ReplaySource", "TelemetrySource", "synthesize_ramp",
]
