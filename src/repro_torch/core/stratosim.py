"""StratoSim analogue: end-to-end datacenter power simulation, one
scenario at a time.

  phase timeline -> chip waveform -> device-level mitigation (GPU floor /
  Firefly) -> datacenter aggregation (+ jitter, distribution loss) -> rack
  mitigation (battery, backstop) -> utility spec validation and frequency
  report.

``simulate`` is the serial reference: each stage runs on the one trace,
through the numpy-facing ``np_apply``, on ``device`` (None: the card).
``simulate_jit`` is the batched engine at B = 1
(``engine.simulate_batch(...).scenario(0)``); ``simulate_cell`` builds the
timeline from a dry-run artifact dict first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.phases import IterationTimeline, from_dryrun_cell
from repro_torch.core.smoothing.base import energy_overhead, np_apply
from repro_torch.core.spec import SpecReport, UtilitySpec, report_from_arrays
from repro_torch.core.spectrum import critical_band_report
from repro_torch.core.waveform import (WaveformConfig, aggregate,
                                       chip_waveform, jitter_shifts,
                                       phase_levels, swing_stats)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SimResult:
    t: np.ndarray
    dc_raw: np.ndarray              # utility-point waveform, no mitigation
    dc_mitigated: np.ndarray
    chip_raw: np.ndarray
    chip_mitigated: Optional[np.ndarray]
    energy_overhead: float
    swing: Dict[str, float]
    swing_mitigated: Dict[str, float]
    bands: Dict[str, float]
    bands_mitigated: Dict[str, float]
    spec_report: Optional[SpecReport]
    aux: Dict


def row_scalars(d: Optional[Dict[str, torch.Tensor]], i: int = 0
                ) -> Dict[str, float]:
    """Row ``i`` of a dict of per-row tensors as floats ({} for None)."""
    return {} if d is None else {k: float(v[i]) for k, v in d.items()}


def simulate(timeline: IterationTimeline, n_chips: int,
             wave_cfg: Optional[WaveformConfig] = None, *,
             device_mitigation=None, rack_mitigation=None,
             spec: Optional[UtilitySpec] = None, hw: Hardware = DEFAULT_HW,
             seed: int = 0, key=None, sample_chips: int = 64,
             device=None) -> SimResult:
    """One scenario, serially.  ``key`` (a key or an int seed) seeds the
    randomness a mitigation draws: the device stage draws from
    ``fold_in(key, 0)``, the rack stage from ``fold_in(key, 1)``, the
    split the batched engine uses, so a keyed serial run is the reference
    for a keyed batched row."""
    cfg = wave_cfg or WaveformConfig()
    dev = resolve_device(device)
    dt = cfg.dt
    k = None if key is None else prng.as_key(key)
    shifts = torch.as_tensor(jitter_shifts(cfg, seed, sample_chips),
                             device=dev)[None]
    chips = torch.tensor([float(n_chips)], dtype=torch.float32, device=dev)

    def agg(chip_row):
        return aggregate(chip_row, chips, shifts, hw)

    levels = torch.as_tensor(phase_levels(timeline, cfg, hw),
                             dtype=torch.float32, device=dev)[None]
    chip = chip_waveform(levels, dt, hw, edp_spikes=cfg.edp_spikes,
                         include_host=cfg.include_host)
    dc_raw = agg(chip)
    aux: Dict = {}
    chip_m = None
    dc = dc_raw
    if device_mitigation is not None:
        chip_m, aux["device"] = np_apply(
            device_mitigation, chip[0].cpu().numpy(), dt,
            None if k is None else prng.fold_in(k, 0), device=dev)
        dc = agg(torch.as_tensor(chip_m, device=dev)[None])
    if rack_mitigation is not None:
        out, aux["rack"] = np_apply(
            rack_mitigation, dc[0].cpu().numpy(), dt,
            None if k is None else prng.fold_in(k, 1), device=dev)
        dc = torch.as_tensor(out, device=dev)[None]

    report = None
    if spec is not None:
        ok, flags, metrics = spec.validate(dc, dt)
        report = report_from_arrays(
            ok[0].item(), {n: v[0].item() for n, v in flags.items()},
            {n: v[0].item() for n, v in metrics.items()})
    return SimResult(
        t=np.arange(dc.shape[1]) * dt, dc_raw=dc_raw[0].cpu().numpy(),
        dc_mitigated=dc[0].cpu().numpy(), chip_raw=chip[0].cpu().numpy(),
        chip_mitigated=chip_m,
        energy_overhead=float(energy_overhead(dc_raw, dc)[0]),
        swing=row_scalars(swing_stats(dc_raw)),
        swing_mitigated=row_scalars(swing_stats(dc)),
        bands=row_scalars(critical_band_report(dc_raw, dt)),
        bands_mitigated=row_scalars(critical_band_report(dc, dt)),
        spec_report=report, aux=aux)


def simulate_jit(timeline: IterationTimeline, n_chips: int,
                 wave_cfg: Optional[WaveformConfig] = None, *,
                 device_mitigation=None, rack_mitigation=None,
                 spec: Optional[UtilitySpec] = None,
                 hw: Hardware = DEFAULT_HW, seed: int = 0, key=None,
                 device=None) -> SimResult:
    """``simulate`` as the batched engine at B = 1 (one
    ``simulate_batch`` call)."""
    from repro_torch.core.engine import simulate_batch  # engine imports us
    return simulate_batch(timeline, n_chips, wave_cfg,
                          device_mitigation=device_mitigation,
                          rack_mitigation=rack_mitigation, spec=spec, hw=hw,
                          seeds=seed, keys=None if key is None else [key],
                          device=resolve_device(device)).scenario(0)


def simulate_cell(cell: Dict, *, steps: int = 30, dt: float = 0.001,
                  overlap: float = 0.0, mfu: float = 0.5,
                  device_mitigation=None, rack_mitigation=None, spec=None,
                  hw: Hardware = DEFAULT_HW, jitter_s: float = 0.002,
                  device=None) -> SimResult:
    """``simulate`` straight from a dry-run artifact dict."""
    tl = from_dryrun_cell(cell, hw, overlap=overlap, mfu=mfu)
    cfg = WaveformConfig(dt=dt, steps=steps, jitter_s=jitter_s)
    return simulate(tl, cell["n_chips"], cfg,
                    device_mitigation=device_mitigation,
                    rack_mitigation=rack_mitigation, spec=spec, hw=hw,
                    device=device)
