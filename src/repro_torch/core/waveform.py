"""Power-waveform synthesis: phase timeline -> sampled watts.

Reproduces the paper's Fig. 1 structure: per-chip square-ish waves between
near-TDP compute and near-idle communication, EDP overshoot spikes at phase
rises, and datacenter aggregation with per-chip jitter (stragglers soften
edges at scale, they do not remove the swing: the job is bulk-synchronous).

The timeline -> samples expansion (``phase_levels``) and the jitter draw
(``jitter_shifts``) fix array shapes and stay in numpy; everything after
the level array works on ``[..., n]`` tensors, batched over leading rows.
``chip_waveform_host`` and ``aggregate_host`` keep the reference's
float64 numpy versions of the two, for the compliance service's host-side
sizing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.phases import (CKPT, COMM, COMPUTE, IDLE, MEMORY,
                                     IterationTimeline, Phase)
from repro_torch.device import resolve_device

MODE_POWER_ATTR = {COMPUTE: "tdp_w", MEMORY: "hbm_bound_w", COMM: "comm_w",
                   IDLE: "idle_w", CKPT: "comm_w"}


def mode_power(mode: str, hw: Hardware = DEFAULT_HW) -> float:
    return getattr(hw.chip, MODE_POWER_ATTR[mode])


@dataclasses.dataclass(frozen=True)
class WaveformConfig:
    dt: float = 0.001                 # 1 ms resolution (telemetry-grade)
    steps: int = 30                   # iterations to synthesize
    ckpt_every: int = 0               # 0 = no checkpoint phases
    ckpt_phase: Optional[Phase] = None
    edp_spikes: bool = True           # 50 ms overshoot at rising edges
    jitter_s: float = 0.0             # per-chip phase jitter (sigma)
    include_host: bool = False        # add per-chip host overhead (Fig. 2)


def phase_levels(tl: IterationTimeline, cfg: WaveformConfig,
                 hw: Hardware = DEFAULT_HW) -> np.ndarray:
    """Base per-sample power levels [n_samples]: no EDP spikes, no host."""
    seq = []
    for s in range(cfg.steps):
        phases = list(tl.phases)
        if cfg.ckpt_every and (s + 1) % cfg.ckpt_every == 0:
            phases.append(cfg.ckpt_phase or Phase("checkpoint", 2.0, CKPT))
        for p in phases:
            n = max(int(round(p.duration_s / cfg.dt)), 1)
            seq.append(np.full(n, mode_power(p.mode, hw)))
    return np.concatenate(seq)


def chip_waveform(levels: torch.Tensor, dt: float,
                  hw: Hardware = DEFAULT_HW, *, edp_spikes: bool = True,
                  include_host: bool = False) -> torch.Tensor:
    """One chip's power trace from its level array ``[..., n]`` (f32)."""
    x = levels.to(torch.float32)
    if edp_spikes:
        x = _add_edp_spikes(x, dt, hw)
    if include_host:
        x = x + hw.server.overhead_per_chip_w()
    return x


def _add_edp_spikes(x: torch.Tensor, dt: float, hw: Hardware) -> torch.Tensor:
    """EDP overshoot: a rise at r plants a spike of ``x[r+1] * edp_factor``
    at r+1 that persists for the EDP window; the output is the running max
    of x against every active spike (a sliding-window max, so the order of
    the rises does not matter)."""
    w = max(int(hw.chip.edp_window_s / dt), 1)
    rise = torch.diff(x, dim=-1) > 0.25 * hw.chip.tdp_w
    src = torch.where(rise, x[..., 1:], torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    src = torch.cat([torch.zeros_like(x[..., :1]), src], dim=-1)
    src = src * hw.chip.edp_factor
    # held[i] = max(src[i-w+1 .. i]); spikes are >= 0, so zero padding on
    # the left is neutral
    lead = x.shape[:-1]
    padded = F.pad(src.reshape(-1, 1, src.shape[-1]), (w - 1, 0))
    held = F.max_pool1d(padded, kernel_size=w, stride=1)
    return torch.maximum(x, held.reshape(*lead, -1))


def jitter_shifts(cfg: WaveformConfig, seed: int = 0,
                  sample_chips: int = 64) -> np.ndarray:
    """Per-chip sample shifts (int32); a degenerate [0] when jitter is
    off, so the aggregation arithmetic is the same either way."""
    if cfg.jitter_s <= 0 or sample_chips <= 1:
        return np.zeros(1, np.int32)
    rng = np.random.default_rng(seed)
    sh = rng.normal(0.0, cfg.jitter_s / cfg.dt, size=sample_chips)
    return np.array([int(round(s)) for s in sh], np.int32)


def aggregate(chip: torch.Tensor, n_chips: torch.Tensor,
              shifts: torch.Tensor, hw: Hardware = DEFAULT_HW
              ) -> torch.Tensor:
    """Datacenter waveform ``[B, n]`` from chip waveforms ``[B, n]``: the
    mean of ``S`` jittered replicas per row (``shifts`` ``[B, S]``),
    scaled to the fleet (``n_chips`` ``[B]``) and the distribution loss.

    Replicas are edge-padded: replica ``s`` of row ``b`` reads
    ``chip[b, clip(i - shifts[b, s], 0, n - 1)]``.  The replicas are
    summed one shift at a time, in order, out of an edge-padded view, so
    no ``[B, S, n]`` gather index is ever built."""
    B, n = chip.shape
    pad = int(shifts.abs().max()) if shifts.numel() else 0
    padded = torch.cat([chip[:, :1].expand(B, pad), chip,
                        chip[:, -1:].expand(B, pad)], dim=-1)
    views = padded.unfold(-1, n, 1)                   # [B, 2*pad + 1, n]
    rows = torch.arange(B, device=chip.device)
    offs = (pad - shifts).to(torch.long)
    total = torch.zeros_like(chip)
    for s in range(shifts.shape[1]):
        total += views[rows, offs[:, s]]
    total = total / shifts.shape[1] * n_chips.to(chip.dtype)[:, None]
    return total * (1.0 + hw.topo.distribution_loss)


def swing_stats(w: torch.Tensor, n_valid: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Swing statistics ``[B]`` of ``w`` ``[B, n]`` over each row's valid
    prefix (``n_valid`` ``[B]``, default the whole row).  The mean is
    accumulated in float64."""
    n = w.shape[-1]
    if n_valid is None:
        n_valid = torch.full((w.shape[0],), n, device=w.device)
    mask = torch.arange(n, device=w.device)[None, :] < n_valid[:, None]
    inf = torch.tensor(float("inf"), dtype=w.dtype, device=w.device)
    peak = torch.where(mask, w, -inf).amax(-1)
    trough = torch.where(mask, w, inf).amin(-1)
    mean = (torch.where(mask, w, 0.0).to(torch.float64).sum(-1)
            / n_valid.to(torch.float64))
    return {
        "peak_w": peak,
        "trough_w": trough,
        "swing_w": peak - trough,
        "mean_w": mean.to(w.dtype),
        "swing_frac": (peak - trough) / torch.clamp(peak, min=1e-9),
    }


def chip_waveform_host(tl: IterationTimeline, cfg: WaveformConfig,
                       hw: Hardware = DEFAULT_HW) -> np.ndarray:
    """One chip's power trace ``[n]`` over ``cfg.steps`` iterations in
    float64 numpy, the reference's host function operation for operation:
    the compliance service sizes its catalog and specs from this trace's
    aggregate, so its swing and mean are the reference's bits."""
    x = phase_levels(tl, cfg, hw)
    if cfg.edp_spikes:
        x = _add_edp_spikes_host(x, cfg.dt, hw)
    if cfg.include_host:
        x = x + hw.server.overhead_per_chip_w()
    return x


def _add_edp_spikes_host(x: np.ndarray, dt: float, hw: Hardware
                         ) -> np.ndarray:
    """EDP overshoot on the host, one rising edge at a time."""
    out = x.copy()
    w = max(int(hw.chip.edp_window_s / dt), 1)
    rises = np.where(np.diff(x) > 0.25 * hw.chip.tdp_w)[0]
    for r in rises:
        hi = min(r + 1 + w, len(out))
        out[r + 1:hi] = np.maximum(out[r + 1:hi],
                                   x[r + 1] * hw.chip.edp_factor)
    return out


def aggregate_host(chip_wave: np.ndarray, n_chips: int, cfg: WaveformConfig,
                   hw: Hardware = DEFAULT_HW, *, seed: int = 0,
                   sample_chips: int = 64) -> np.ndarray:
    """The datacenter waveform of ``chip_waveform_host``'s trace in
    float64 numpy: the mean of ``sample_chips`` edge-padded jittered
    replicas, scaled to the fleet (the reference's host ``aggregate``)."""
    shifts = jitter_shifts(cfg, seed, sample_chips)
    n = len(chip_wave)
    idx = np.clip(np.arange(n)[None, :] - shifts[:, None], 0, n - 1)
    total = chip_wave[idx].mean(axis=0) * n_chips
    return total * (1.0 + hw.topo.distribution_loss)


def job_waveform(tl: IterationTimeline, n_chips: int,
                 cfg: Optional[WaveformConfig] = None,
                 hw: Hardware = DEFAULT_HW, *, seed: int = 0,
                 sample_chips: int = 64, device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``(t_seconds, watts)`` at the utility point of coupling: the chip
    waveform of ``tl`` aggregated over ``n_chips`` with the jitter draw of
    ``seed``, computed on ``device`` (None: the card), host float32."""
    cfg = cfg or WaveformConfig()
    dev = resolve_device(device)
    levels = torch.as_tensor(phase_levels(tl, cfg, hw), dtype=torch.float32,
                             device=dev)[None]
    chip = chip_waveform(levels, cfg.dt, hw, edp_spikes=cfg.edp_spikes,
                         include_host=cfg.include_host)
    shifts = torch.as_tensor(jitter_shifts(cfg, seed, sample_chips),
                             device=dev)[None]
    chips = torch.tensor([float(n_chips)], dtype=torch.float32, device=dev)
    w = aggregate(chip, chips, shifts, hw)[0].cpu().numpy()
    return np.arange(len(w)) * cfg.dt, w
