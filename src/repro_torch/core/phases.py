"""Iteration timelines: the per-iteration power phases of a training job.

A timeline is a sequence of ``Phase(name, duration_s, mode)``, where
``mode`` is the power mode of the chip during that phase;
``core/waveform.py`` maps modes to watts.  Building a timeline from a
dry-run artifact (``from_dryrun_cell``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# power modes
COMPUTE, MEMORY, COMM, IDLE, CKPT = "compute", "memory", "comm", "idle", "ckpt"


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    duration_s: float
    mode: str  # compute | memory | comm | idle | ckpt


@dataclasses.dataclass(frozen=True)
class IterationTimeline:
    phases: Sequence[Phase]

    @property
    def period_s(self) -> float:
        return sum(p.duration_s for p in self.phases)

    def scaled(self, factor: float) -> "IterationTimeline":
        return IterationTimeline(tuple(
            dataclasses.replace(p, duration_s=p.duration_s * factor)
            for p in self.phases))


def synthetic_timeline(period_s: float = 1.0, comm_frac: float = 0.25,
                       moe_notch: bool = False) -> IterationTimeline:
    """Fig.1-like timeline: compute, then the gradient-sync valley (and,
    with ``moe_notch``, a mid-iteration all-to-all notch)."""
    tc = period_s * (1 - comm_frac)
    phases = []
    if moe_notch:
        phases += [Phase("fwd", tc * 0.33, COMPUTE),
                   Phase("moe-a2a", period_s * comm_frac * 0.3, COMM),
                   Phase("bwd", tc * 0.67, COMPUTE),
                   Phase("grad-sync", period_s * comm_frac * 0.7, COMM)]
    else:
        phases += [Phase("fwd+bwd", tc, COMPUTE),
                   Phase("grad-sync", period_s * comm_frac, COMM)]
    return IterationTimeline(tuple(phases))
