"""Iteration timelines: the per-iteration power phases of a training job.

A timeline is a sequence of ``Phase(name, duration_s, mode)``, where
``mode`` is the power mode of the chip during that phase;
``core/waveform.py`` maps modes to watts.  ``from_dryrun_cell`` builds a
timeline from a dry-run artifact dict (per-chip FLOPs, bytes and
collective bytes of one step); ``load_cell`` reads such a file.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence

from repro_torch.core.hardware import DEFAULT_HW, Hardware

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


def from_dryrun_cell(cell: Dict, hw: Hardware = DEFAULT_HW, *,
                     overlap: float = 0.0,
                     mfu: float = 0.5) -> IterationTimeline:
    """A per-iteration timeline from a dry-run artifact dict.

    overlap: fraction of collective time hidden under compute.
    mfu:     achieved fraction of peak FLOPs during compute phases.
    """
    chips = cell["n_chips"]
    flops_per_chip = cell["exact"]["flops"] / chips
    bytes_per_chip = cell["exact"]["bytes"] / chips
    coll = cell.get("collectives", {})
    coll_bytes = sum(coll.values())  # already per chip

    t_flops = flops_per_chip / (hw.chip.peak_flops_bf16 * mfu)
    t_mem = bytes_per_chip / hw.chip.hbm_bw
    t_comm = coll_bytes / (hw.chip.ici_bw_per_link * hw.chip.ici_links)

    compute_mode = COMPUTE if t_flops >= t_mem else MEMORY
    t_compute = max(t_flops, t_mem)
    t_exposed = t_comm * (1.0 - overlap)

    # an MoE all-to-all is a mid-iteration comm notch; the rest of the
    # exposed comm is the gradient-sync tail
    a2a = coll.get("all-to-all", 0.0) * (1.0 - overlap)
    t_a2a = a2a / (hw.chip.ici_bw_per_link * hw.chip.ici_links)
    t_tail = max(t_exposed - t_a2a, 0.0)

    phases: List[Phase] = []
    if t_a2a > 0:
        phases.append(Phase("fwd", t_compute * 0.33, compute_mode))
        phases.append(Phase("moe-a2a", t_a2a, COMM))
        phases.append(Phase("bwd", t_compute * 0.67, compute_mode))
    else:
        phases.append(Phase("fwd+bwd", t_compute, compute_mode))
    phases.append(Phase("grad-sync", max(t_tail, 1e-4), COMM))
    return IterationTimeline(tuple(phases))


def checkpoint_phase(cell: Dict, hw: Hardware = DEFAULT_HW,
                     storage_bw_per_chip: float = 1e9) -> Phase:
    """Periodic checkpoint write: chips near-idle while state drains."""
    state_bytes = cell.get("memory", {}).get("state_bytes_per_device", 8e9)
    return Phase("checkpoint", state_bytes / storage_bw_per_chip, CKPT)


def load_cell(path_or_dir: str, arch: str = "", shape: str = "",
              mesh: str = "single") -> Dict:
    """A dry-run cell as a dict: the JSON file ``path_or_dir``, or
    ``<arch>__<shape>__<mesh>.json`` inside it when it is a directory."""
    p = path_or_dir
    if os.path.isdir(path_or_dir):
        p = os.path.join(path_or_dir, f"{arch}__{shape}__{mesh}.json")
    with open(p) as f:
        return json.load(f)


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
