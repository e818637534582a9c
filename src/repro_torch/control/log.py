"""Structured decision record of the control loop.

Every escalation, dispatch, release and failure lands in a
``ControlRecord``; per-tick amplitude and level samples land in
``series``.  ``summary()`` reduces a run to detection lead before breach,
dispatch latency percentiles and post-intervention recession time.
Every stored value is a Python number, str, list or dict of them, never
a tensor, so the log is JSON-safe.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def _pctl(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclasses.dataclass
class ControlRecord:
    tick: int
    t_s: float
    action: str                # escalate | dispatch:<rung> | release:<rung>
                               # | dispatch_failed:<rung>
    level: int                 # controller target level after the action
    bin_hz: Optional[float] = None
    amplitude_w: float = 0.0   # worst-bin slope-projected amplitude
    margin_w: float = 0.0      # trigger_w - amplitude (negative = over)
    latency_s: float = 0.0     # wall-clock build/dispatch latency
    params: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ControlLog:
    freqs: tuple = ()
    trigger_w: float = 0.0
    release_w: float = 0.0
    breach_w: float = 0.0
    # when the *uncontrolled* trace would have breached (offline monitor
    # on the raw replay): the baseline detection lead is measured against
    counterfactual_breach_t_s: Optional[float] = None
    records: List[ControlRecord] = dataclasses.field(default_factory=list)
    series: List[Dict] = dataclasses.field(default_factory=list)

    def record(self, **kw) -> ControlRecord:
        rec = ControlRecord(**kw)
        self.records.append(rec)
        return rec

    def sample(self, *, tick: int, t_s: float, level: int, amps,
               amps_eff) -> None:
        self.series.append({
            "tick": int(tick), "t_s": round(float(t_s), 6),
            "level": int(level),
            "amps_w": [float(a) for a in amps],
            "amps_eff_w": [float(a) for a in amps_eff],
        })

    # -- reductions ---------------------------------------------------------

    def dispatch_latencies(self) -> List[float]:
        return [r.latency_s for r in self.records
                if r.action.startswith("dispatch:")]

    def first(self, prefix: str) -> Optional[ControlRecord]:
        for r in self.records:
            if r.action.startswith(prefix):
                return r
        return None

    def breach_t(self) -> Optional[float]:
        """First time the *raw* worst-bin amplitude crosses the breach
        level (the spec threshold the controller must beat)."""
        for row in self.series:
            if max(row["amps_w"]) > self.breach_w:
                return row["t_s"]
        return None

    def recession_t(self) -> Optional[float]:
        """First time after the last dispatch that the raw worst-bin
        amplitude sits below the release-hysteresis level."""
        last = None
        for r in self.records:
            if r.action.startswith("dispatch:"):
                last = r.t_s
        if last is None:
            return None
        for row in self.series:
            if row["t_s"] > last and max(row["amps_w"]) < self.release_w:
                return row["t_s"]
        return None

    def summary(self) -> Dict:
        esc = self.first("escalate")
        disp = self.first("dispatch:")
        breach = self.breach_t()
        recede = self.recession_t()
        lats = self.dispatch_latencies()
        # detected-before-breach margin: against the observed breach if one
        # happened, else against the counterfactual (uncontrolled) breach
        ref_breach = breach if breach is not None \
            else self.counterfactual_breach_t_s
        return {
            "n_ticks": len(self.series),
            "n_records": len(self.records),
            "n_dispatches": len(lats),
            "final_level": (self.series[-1]["level"] if self.series else 0),
            "first_escalate_t_s": (esc.t_s if esc else None),
            "first_dispatch_t_s": (disp.t_s if disp else None),
            "breach_t_s": breach,
            "counterfactual_breach_t_s": self.counterfactual_breach_t_s,
            "detection_lead_s": (ref_breach - esc.t_s
                                 if esc is not None and ref_breach is not None
                                 else None),
            "recession_t_s": recede,
            "dispatch_latency_s": {
                "p50": _pctl(lats, 50), "p90": _pctl(lats, 90),
                "max": (max(lats) if lats else None),
            },
            "interventions": [
                {"action": r.action, "t_s": r.t_s, "bin_hz": r.bin_hz,
                 "latency_s": r.latency_s, "params": r.params}
                for r in self.records if ":" in r.action],
        }

    # -- rendering ----------------------------------------------------------

    def timeline(self) -> str:
        """Human-readable decision timeline."""
        lines = [f"{'tick':>5} {'t[s]':>8} {'bin[Hz]':>8} {'amp[W]':>12} "
                 f"{'margin[W]':>12} {'lvl':>3} {'lat[ms]':>8}  action"]
        for r in self.records:
            lines.append(
                f"{r.tick:>5} {r.t_s:>8.2f} "
                f"{('-' if r.bin_hz is None else f'{r.bin_hz:g}'):>8} "
                f"{r.amplitude_w:>12.4g} {r.margin_w:>12.4g} {r.level:>3} "
                f"{r.latency_s * 1e3:>8.2f}  {r.action}")
        return "\n".join(lines)

    def to_json(self) -> Dict:
        return {
            "freqs_hz": list(self.freqs),
            "trigger_w": self.trigger_w, "release_w": self.release_w,
            "breach_w": self.breach_w,
            "records": [dataclasses.asdict(r) for r in self.records],
            "series": self.series,
            "summary": self.summary(),
        }

    def dumps(self, **kw) -> str:
        return json.dumps(self.to_json(), **kw)
