"""GridController: per-bin threshold-with-hysteresis + slope early warning.

The policy layer between detection and dispatch.  Each grid-critical bin
runs its own copy of the *shared* escalation state machine
(``core.telemetry.escalation_step``, the gating the ``TelemetryBackstop``
runs offline, warm-up gate included), fed not with the raw amplitude but
with the slope-projected amplitude

    amp_eff = amp + max(slope, 0) * lead_s

so a bin trending toward its trigger escalates ``lead_s`` seconds early.
Escalation triggers at ``trigger_frac`` of the breach amplitude and
releases with hysteresis at ``release_frac`` (sustained for
``release_ticks``).  The controller's target level is the worst bin's
level; the intervention ladder maps levels to actions.

The K machines are independent, elementwise, and step together as one
``[K]`` carry.  Everything here is a handful of scalars per tick and
stays on the host: CPU tensors and numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.control.detector import DetectorFrame
from repro_torch.core.telemetry import escalation_init, escalation_step
from repro_torch.kernels.goertzel.ops import NO_PAD


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    breach_w: float              # spec's per-bin breach amplitude
    trigger_frac: float = 0.85   # escalate at this fraction of breach
    release_frac: float = 0.60   # hysteresis release level
    lead_s: float = 2.0          # slope projection horizon (early warning)
    sustain_ticks: int = 2       # ticks above trigger before escalating
    release_ticks: int = 4       # ticks below release before de-escalating
    max_level: int = 3           # depth of the intervention ladder

    @property
    def trigger_w(self) -> float:
        return self.breach_w * self.trigger_frac

    @property
    def release_w(self) -> float:
        return self.breach_w * self.release_frac


@dataclasses.dataclass
class ControlDecision:
    tick: int
    t_s: float
    levels: np.ndarray           # [K] per-bin escalation level
    target_level: int            # max over bins -> ladder depth to hold
    amps_eff: np.ndarray         # [K] slope-projected amplitudes
    margins_w: np.ndarray        # [K] trigger_w - amp_eff (negative = over)
    worst_bin: int               # index of the most-escalated/closest bin


class GridController:
    """Per-bin hysteresis escalation over detector frames."""

    def __init__(self, cfg: ControllerConfig, freqs, win: int):
        self.cfg = cfg
        self.freqs = tuple(float(f) for f in freqs)
        self.win = int(win)
        self._carry = tuple(escalation_init(len(self.freqs)).unbind(-1))

    def decide(self, frame: DetectorFrame) -> ControlDecision:
        cfg = self.cfg
        amps_eff = frame.amps + np.maximum(frame.slopes, 0.0) * cfg.lead_s
        self._carry, level = escalation_step(
            self._carry, torch.from_numpy(np.asarray(amps_eff, np.float32)),
            torch.tensor(frame.sample_idx, dtype=torch.int64),
            threshold=cfg.trigger_w, win=self.win, n=NO_PAD,
            sustain_n=cfg.sustain_ticks, cool_n=cfg.release_ticks,
            max_level=cfg.max_level, release=cfg.release_w)
        levels = level.numpy().astype(np.int32)
        margins = cfg.trigger_w - amps_eff
        # worst bin: highest level, margin as the tiebreak
        worst = int(np.lexsort((margins, -levels))[0])
        return ControlDecision(tick=frame.tick, t_s=frame.t_s, levels=levels,
                               target_level=int(levels.max()),
                               amps_eff=np.asarray(amps_eff, np.float32),
                               margins_w=np.asarray(margins, np.float32),
                               worst_bin=worst)
