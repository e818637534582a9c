"""Fast telemetry-based backstop (paper Sec. IV-E), hard semantics.

Streams the datacenter waveform through per-bin spectral monitors
(sliding-window Goertzel resonators at the critical frequencies) and
escalates through tiered responses when a critical bin's amplitude stays
above threshold:

  level 0  observe
  level 1  soft throttle   (scale the AC component of the load by alpha1)
  level 2  power shed      (cap total power at shed_frac x mean)
  level 3  disconnect      (drop to idle_frac x mean)

De-escalation follows ``cooldown_s`` at or below threshold.  Escalation
is gated until one full window has streamed, so a trace shorter than one
window never escalates.

The monitor is the fused one (``kernels/goertzel/ops.
sliding_monitor_fused``: kernel A, then the escalation machine on kernel
D).  ``use_pallas`` and ``fused_scan`` are kept for configuration parity
with the reference and select the same fused monitor; the reference's
cumsum oracle path is not ported.

``smooth_tau > 0`` keeps the hard forward and adds a straight-through
term, ``(soft - soft.detach()) * (resp - w)``, whose value is 0 and whose
gradient carries the engagement margin's sigmoid to ``amp_threshold_w``
(the response gains get theirs through the selected branches).  The
worst-bin amplitude comes from kernel A, and when ``w`` requires a
gradient it carries one (``ops.monitor_worst_grad``: kernel E recomputes
the bins, ``csrc/monitor_adjoint.cu`` runs the adjoint), so the gradient
with respect to ``w`` also flows through the monitor, as the reference's
does through its jnp monitor.  The levels, the detection index and the
peaks are discrete and carry none.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.smoothing.base import mean64, stack_params
from repro_torch.core.smoothing.relax import sigmoid_gate
from repro_torch.kernels.goertzel.ops import (monitor_worst_grad,
                                              sliding_monitor_fused)


@dataclasses.dataclass(frozen=True)
class TelemetryBackstop:
    critical_hz: Sequence[float] = (0.5, 1.0, 2.0, 9.0)
    window_s: float = 8.0
    amp_threshold_w: float = 1e6            # per-bin amplitude trigger
    sustain_s: float = 2.0                  # must persist before escalation
    cooldown_s: float = 4.0
    alpha1: float = 0.5                     # level-1 AC attenuation
    shed_frac: float = 0.7                  # level-2 cap (fraction of mean)
    idle_frac: float = 0.2                  # level-3 floor
    use_pallas: bool = True
    fused_scan: bool = True
    # 0 = exact hard semantics; > 0 = the design-time relaxation
    smooth_tau: float = 0.0

    STATIC_FIELDS = ("critical_hz", "window_s", "sustain_s", "cooldown_s",
                     "use_pallas", "fused_scan", "smooth_tau")
    PARAMS = ("amp_threshold_w", "alpha1", "shed_frac", "idle_frac")

    def __post_init__(self):
        object.__setattr__(self, "critical_hz",
                           tuple(float(f) for f in self.critical_hz))

    @classmethod
    def apply_batch(cls, mits: Sequence["TelemetryBackstop"],
                    w: torch.Tensor, dt: float
                    ) -> Tuple[torch.Tensor, Dict]:
        m0 = mits[0]
        w = w.to(torch.float32)
        win = max(int(m0.window_s / dt), 8)
        p = stack_params(mits, cls.PARAMS, w.device)
        worst, levels, detect, _peaks = sliding_monitor_fused(
            w.detach(), dt, m0.critical_hz, win=win,
            threshold=p["amp_threshold_w"].detach(),
            sustain_n=max(int(m0.sustain_s / dt), 1),
            cool_n=max(int(m0.cooldown_s / dt), 1))
        mean = mean64(w)[:, None]
        r1 = mean + p["alpha1"][:, None] * (w - mean)
        out = torch.where(levels == 1, r1, w)
        out = torch.where(levels == 2,
                          torch.minimum(w, p["shed_frac"][:, None] * mean),
                          out)
        out = torch.where(levels == 3, (p["idle_frac"][:, None] * mean)
                          .expand_as(w), out)
        if m0.smooth_tau:
            # forward: the hard response (the added term is 0); backward:
            # the sigmoid's margin to the threshold, with the level-1
            # throttle as the response of samples that did not escalate
            thr = p["amp_threshold_w"][:, None]
            if w.requires_grad:
                worst = monitor_worst_grad(w, worst, dt, m0.critical_hz,
                                           win=win)
            resp = torch.where(levels > 0, out, r1)
            soft = sigmoid_gate(worst - thr, m0.smooth_tau,
                                torch.maximum(thr, torch.ones_like(thr)))
            out = out + (soft - soft.detach()) * (resp - w)
        return out, {
            "max_level": levels.amax(-1),
            "detect_latency_s": torch.where(
                detect >= 0, detect.to(torch.float32) * dt, -1.0),
            "levels": levels,
            "worst_bin_amp": worst,
        }
