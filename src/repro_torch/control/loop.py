"""The closed loop: detection -> decision -> intervention dispatch.

``ControlLoop`` drives one ``TelemetrySource`` through the online
detector and controller, and when the controller's target level moves it
builds the ladder rungs (within a ``dispatch_ticks`` budget) and pushes
the cumulative intervention stack back into the source, so the next
tick's samples already reflect the dispatched mitigation, the monitored
amplitude recedes, and the hysteresis releases the rungs again.
Everything observable lands in the ``ControlLog``.

``watch_trace`` is the one-call assembly: it replays a trace through the
loop on one device (``device=None``: the card) and marks when the
uncontrolled trace would have breached, from one offline
``sliding_bin_power`` call (kernel E) on the raw replay.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.control.controller import (ControlDecision, ControllerConfig,
                                            GridController)
from repro_torch.control.detector import OnlineGoertzelDetector
from repro_torch.control.interventions import InterventionLadder
from repro_torch.control.log import ControlLog
from repro_torch.control.stream import ReplaySource, TelemetrySource
from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.spectrum import GRID_CRITICAL_HZ
from repro_torch.device import resolve_device
from repro_torch.kernels.goertzel.ops import sliding_bin_power, trace_mean


class ControlLoop:
    """Run a controller over a stream, dispatching ladder interventions.

    ``dispatch_ticks`` is the dispatch budget: a level change decided at
    tick t is applied to the source after at most that many ticks
    (1 = at the end of the deciding tick, before the next chunk
    streams).  Rungs are cumulative; a release drops rungs above the new
    target and clears their ladder cache so a re-escalation re-solves on
    fresh history.
    """

    def __init__(self, source: TelemetrySource,
                 detector: OnlineGoertzelDetector,
                 controller: GridController, ladder: InterventionLadder, *,
                 log: Optional[ControlLog] = None, dispatch_ticks: int = 1,
                 history_s: float = 8.0):
        self.source = source
        self.detector = detector
        self.controller = controller
        self.ladder = ladder
        self.log = log if log is not None else ControlLog(
            freqs=detector.freqs,
            trigger_w=controller.cfg.trigger_w,
            release_w=controller.cfg.release_w,
            breach_w=controller.cfg.breach_w)
        self.dispatch_ticks = max(int(dispatch_ticks), 1)
        self.history_n = max(int(history_s / detector.dt), detector.win)
        self.applied_level = 0
        self.active: Dict[int, object] = {}       # rung -> Intervention
        self._due: Optional[int] = None           # tick the dispatch is due

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, decision: ControlDecision) -> None:
        target = decision.target_level
        f_hz = self.controller.freqs[decision.worst_bin]
        amp = float(decision.amps_eff[decision.worst_bin])
        margin = float(decision.margins_w[decision.worst_bin])
        history = self.source.history(self.history_n)
        t0 = time.perf_counter()
        for rung in range(1, target + 1):
            if rung in self.active:
                continue
            iv = self.ladder.build(rung, history, f_hz)
            name = InterventionLadder.RUNGS[rung - 1]
            if iv is None:
                self.log.record(
                    tick=decision.tick, t_s=decision.t_s,
                    action=f"dispatch_failed:{name}", level=target,
                    bin_hz=f_hz, amplitude_w=amp, margin_w=margin,
                    latency_s=time.perf_counter() - t0)
                continue
            self.active[rung] = iv
            self.log.record(
                tick=decision.tick, t_s=decision.t_s,
                action=f"dispatch:{iv.name}", level=target, bin_hz=f_hz,
                amplitude_w=amp, margin_w=margin,
                latency_s=iv.build_latency_s, params=dict(iv.params))
        for rung in [r for r in self.active if r > target]:
            iv = self.active.pop(rung)
            self.ladder.release(rung)
            self.log.record(
                tick=decision.tick, t_s=decision.t_s,
                action=f"release:{iv.name}", level=target, bin_hz=f_hz,
                amplitude_w=amp, margin_w=margin)
        self.source.apply_interventions(
            [self.active[r] for r in sorted(self.active)])
        self.applied_level = target

    # -- the loop -----------------------------------------------------------

    def run(self, max_ticks: Optional[int] = None) -> ControlLog:
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            chunk = self.source.next_tick()
            if chunk is None:
                break
            frame = self.detector.step(chunk)
            decision = self.controller.decide(frame)
            self.log.sample(tick=frame.tick, t_s=frame.t_s,
                            level=decision.target_level, amps=frame.amps,
                            amps_eff=decision.amps_eff)
            target = decision.target_level
            if target != self.applied_level:
                if target > self.applied_level and self._due is None:
                    k = decision.worst_bin
                    self.log.record(
                        tick=frame.tick, t_s=frame.t_s, action="escalate",
                        level=target, bin_hz=self.controller.freqs[k],
                        amplitude_w=float(decision.amps_eff[k]),
                        margin_w=float(decision.margins_w[k]))
                if self._due is None:
                    self._due = frame.tick + self.dispatch_ticks - 1
                if frame.tick >= self._due:
                    self._dispatch(decision)
                    self._due = None
            else:
                self._due = None
            ticks += 1
        return self.log


def watch_trace(w: np.ndarray, dt: float, *, spec, n_chips: int,
                freqs: Optional[Sequence[float]] = None,
                window_s: float = 4.0, tick_s: float = 0.5,
                tick_sizes: Optional[Sequence[int]] = None,
                breach_w: Optional[float] = None,
                trigger_frac: float = 0.85, release_frac: float = 0.60,
                lead_s: float = 2.0, sustain_ticks: int = 2,
                release_ticks: int = 4, dispatch_ticks: int = 1,
                design_method: str = "grid", warmstart=None,
                hw: Hardware = DEFAULT_HW, history_s: float = 8.0,
                stagger_groups: int = 4, mean: Optional[float] = None,
                max_ticks: Optional[int] = None, sensor=None,
                device=None) -> ControlLog:
    """Close the loop over one replayed trace; returns the ``ControlLog``.

    ``breach_w`` defaults to the spec's per-bin amplitude limit, or half
    its dynamic-range window when no explicit bin limit is set (a bin of
    amplitude a contributes 2a of peak-to-trough).  ``mean`` defaults to
    the trace's float64 mean (``trace_mean``), the offline monitor's
    centring.  Everything runs on ``device`` (None: the card).
    """
    dev = resolve_device(device)
    w = np.asarray(w, np.float32)
    if freqs is None:
        freqs = GRID_CRITICAL_HZ
    if breach_w is None:
        breach_w = (spec.freq.max_bin_amplitude_w
                    if spec.freq.max_bin_amplitude_w is not None
                    else 0.5 * spec.time.dynamic_range_w)
    if mean is None:
        mean = trace_mean(w)
    source = ReplaySource(w, dt, tick_s=tick_s, tick_sizes=tick_sizes,
                          sensor=sensor)
    cfg = ControllerConfig(breach_w=float(breach_w),
                           trigger_frac=trigger_frac,
                           release_frac=release_frac, lead_s=lead_s,
                           sustain_ticks=sustain_ticks,
                           release_ticks=release_ticks)
    # the fused detector's shared escalation machine mirrors the
    # controller's trigger/release band (per-sample telemetry riding along
    # in the frames; the controller decides from amplitudes and slopes)
    detector = OnlineGoertzelDetector(dt, freqs, window_s=window_s,
                                      mean=mean, threshold_w=cfg.trigger_w,
                                      release_w=cfg.release_w,
                                      sustain_s=sustain_ticks * tick_s,
                                      cooldown_s=release_ticks * tick_s,
                                      device=dev)
    controller = GridController(cfg, freqs, detector.win)
    ladder = InterventionLadder(spec=spec, n_chips=n_chips, dt=dt,
                                release_amp_w=cfg.release_w, hw=hw,
                                design_method=design_method,
                                warmstart=warmstart,
                                stagger_groups=stagger_groups, device=dev)
    loop = ControlLoop(source, detector, controller, ladder,
                       dispatch_ticks=dispatch_ticks, history_s=history_s)
    log = loop.run(max_ticks=max_ticks)
    # counterfactual breach: when the *uncontrolled* trace would have
    # crossed the breach amplitude (offline monitor on the raw replay)
    raw_amps = sliding_bin_power(torch.as_tensor(source.raw, device=dev),
                                 float(dt), tuple(detector.freqs),
                                 win=detector.win)
    over = torch.nonzero(raw_amps.amax(1) > cfg.breach_w)
    if len(over):
        log.counterfactual_breach_t_s = float(int(over[0, 0]) * dt)
    return log
