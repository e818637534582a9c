"""Staggered ramp scheduling (paper Sec. IV-A: 'staggering the load ramp-up
across all the participating GPUs'; applied here at rack/pod granularity).

Job start, checkpoint-restore restart, and elastic re-meshing all slam the
full fleet from idle to TDP at once — a worst-case ramp event. Given the
utility's ramp limit, schedule per-rack start offsets so the aggregate
dP/dt stays in spec; the same schedule runs in reverse for drain-down.
The control plane's stagger rung (``control/interventions.py``) reports
its comb of start offsets as a ``StaggerSchedule``.

Host numpy, as in the reference: a schedule is a handful of offsets.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StaggerSchedule:
    offsets_s: np.ndarray          # per-rack start offset
    rack_ramp_w_per_s: float       # within-rack ramp rate

    @property
    def total_s(self) -> float:
        return float(self.offsets_s.max())


def plan_stagger(n_racks: int, rack_power_w: float,
                 ramp_limit_w_per_s: float,
                 rack_ramp_s: float = 2.0) -> StaggerSchedule:
    """Offsets so the aggregate ramp never exceeds the utility limit.

    If a single rack's natural ramp already exceeds the limit, the per-rack
    ramp itself is stretched (that is what the GPU smoothing feature's
    programmable ramp-up rate is for, Sec. IV-B)."""
    rack_ramp = rack_power_w / rack_ramp_s
    if rack_ramp > ramp_limit_w_per_s:
        rack_ramp = ramp_limit_w_per_s
        rack_ramp_s = rack_power_w / rack_ramp
    # racks that may ramp concurrently without exceeding the limit
    conc = max(int(ramp_limit_w_per_s / rack_ramp), 1)
    offsets = (np.arange(n_racks) // conc) * rack_ramp_s
    return StaggerSchedule(offsets_s=offsets.astype(np.float64),
                           rack_ramp_w_per_s=rack_ramp)


def ramp_waveform(sched: StaggerSchedule, n_racks: int, rack_power_w: float,
                  dt: float = 0.01, *, direction: int = +1) -> np.ndarray:
    """Aggregate power during a staggered ramp (direction=-1: drain)."""
    rack_ramp_s = rack_power_w / sched.rack_ramp_w_per_s
    total = sched.total_s + rack_ramp_s + 1.0
    n = int(total / dt) + 1
    t = np.arange(n) * dt
    w = np.zeros(n)
    for r in range(n_racks):
        t0 = sched.offsets_s[r]
        ramp = np.clip((t - t0) / rack_ramp_s, 0.0, 1.0) * rack_power_w
        w += ramp
    if direction < 0:
        w = w[::-1].copy()
    return w


def max_ramp(w: np.ndarray, dt: float, window_s: float = 0.1) -> float:
    k = max(int(window_s / dt), 1)
    box = np.convolve(w, np.ones(k) / k, mode="valid")
    return float(np.abs(np.diff(box)).max() / dt)
