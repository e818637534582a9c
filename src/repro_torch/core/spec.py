"""Utility specifications (paper Sec. III) and compliance validation.

Time domain: ramp-up / ramp-down rate limits (W/s) and a dynamic power
range (max deviation within a sliding window), Fig. 4.  Frequency domain:
a critical band and a cap on the fraction of AC spectral energy inside it.

``UtilitySpec.validate`` judges a batch of same-length waveforms
``[B, n]`` and returns per-violation boolean flags and the metrics, one
value per row.  A spec's *family* (band edges, window sizes, whether a
bin-amplitude check exists) fixes which metrics exist; its *limits* are
the numeric thresholds they are compared against.

The ramp box filter is a difference of float64 prefix sums: an O(n)
moving sum whose float32 cancellation would otherwise swamp the ramp of a
smoothed multi-megawatt trace.  Means and deviations are reduced in
float64 too; the FFT and the comparisons run in float32, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spectrum import (band_amplitude_w, band_energy_fraction,
                                       row_aligned)

VIOLATION_ORDER = ("ramp_up", "ramp_down", "dynamic_range",
                   "band_energy", "band_amplitude")


@dataclasses.dataclass(frozen=True)
class TimeDomainSpec:
    ramp_up_w_per_s: float
    ramp_down_w_per_s: float
    dynamic_range_w: float          # allowed peak-to-trough in window
    window_s: float = 1.0
    # ramp measurement granularity: utilities meter over >= this interval,
    # so single-sample dP/dt is averaged over ramp_window_s first
    ramp_window_s: float = 0.1


@dataclasses.dataclass(frozen=True)
class FrequencyDomainSpec:
    band_hz: Tuple[float, float] = (0.1, 20.0)
    max_energy_fraction: float = 0.2
    max_bin_amplitude_w: Optional[float] = None
    # the fraction cap only applies when the AC component is material:
    # a flat load with microscopic residual wobble is compliant even if
    # 100% of that wobble sits in-band
    min_ac_rms_frac: float = 0.005

    def __post_init__(self):
        object.__setattr__(self, "band_hz", tuple(self.band_hz))


@dataclasses.dataclass(frozen=True)
class UtilitySpec:
    name: str
    time: TimeDomainSpec
    freq: FrequencyDomainSpec

    def limits(self) -> Dict[str, float]:
        """The numeric thresholds, rounded to float32 as the reference
        compares them.  ``max_bin_amplitude_w`` is present iff the check
        exists (its existence is part of the family)."""
        lim = {
            "ramp_up_w_per_s": self.time.ramp_up_w_per_s,
            "ramp_down_w_per_s": self.time.ramp_down_w_per_s,
            "dynamic_range_w": self.time.dynamic_range_w,
            "max_energy_fraction": self.freq.max_energy_fraction,
            "min_ac_rms_frac": self.freq.min_ac_rms_frac,
        }
        if self.freq.max_bin_amplitude_w is not None:
            lim["max_bin_amplitude_w"] = self.freq.max_bin_amplitude_w
        return {k: float(np.float32(v)) for k, v in lim.items()}

    def family(self) -> "UtilitySpec":
        """The shape-determining residue of this spec: limits canonicalized
        to 1.0, name dropped.  Specs of one family measure the same
        metrics."""
        return UtilitySpec(
            "family",
            TimeDomainSpec(ramp_up_w_per_s=1.0, ramp_down_w_per_s=1.0,
                           dynamic_range_w=1.0, window_s=self.time.window_s,
                           ramp_window_s=self.time.ramp_window_s),
            FrequencyDomainSpec(
                band_hz=self.freq.band_hz, max_energy_fraction=1.0,
                max_bin_amplitude_w=(None if self.freq.max_bin_amplitude_w
                                     is None else 1.0),
                min_ac_rms_frac=1.0))

    def _metrics(self, w: torch.Tensor, dt: float
                 ) -> Dict[str, torch.Tensor]:
        """Metrics ``[B]`` of ``w`` ``[B, n]``.  Keys are present iff the
        waveform is long enough to measure them."""
        w = w.to(torch.float32)
        L = w.shape[-1]
        m: Dict[str, torch.Tensor] = {}
        # ---- ramps (averaged over the metering window)
        k = max(int(self.time.ramp_window_s / dt), 1)
        if L > k:
            c = torch.cumsum(w.to(torch.float64), dim=-1)
            c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=-1)
            box = (c[:, k:] - c[:, :-k]) / k
            dp = torch.diff(box, dim=-1) / dt
            m["max_ramp_up_w_per_s"] = torch.clamp(
                dp.amax(-1), min=0.0).to(torch.float32)
            m["max_ramp_down_w_per_s"] = torch.clamp(
                -dp.amin(-1), min=0.0).to(torch.float32)
        # ---- dynamic range over windows starting every n // 8 samples
        n = max(int(self.time.window_s / dt), 2)
        if L >= n:
            stride = max(n // 8, 1)
            n_starts = len(range(0, L - n, stride))
            if n_starts:
                seg = w.unfold(-1, n, stride)[:, :n_starts]
                rng = (seg.amax(-1) - seg.amin(-1)).amax(-1)
            else:
                # exactly one window: the reference reports 0.0
                rng = torch.zeros(w.shape[0], device=w.device)
            m["dynamic_range_w"] = rng
        # ---- frequency domain
        f_lo, f_hi = self.freq.band_hz
        m["band_energy_fraction"] = band_energy_fraction(w, dt, f_lo, f_hi)
        w64 = row_aligned(w.to(torch.float64))
        m["ac_rms_frac"] = (w64.std(-1, unbiased=False)
                            / torch.clamp(w64.mean(-1), min=1e-9)
                            ).to(torch.float32)
        if self.freq.max_bin_amplitude_w is not None:
            m["band_bin_amplitude_w"] = band_amplitude_w(w, dt, f_lo, f_hi)
        return m

    def validate(self, w: torch.Tensor, dt: float
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                            Dict[str, torch.Tensor]]:
        """``(ok [B], violation flags, metrics)`` of ``w`` ``[B, n]``."""
        lim = self.limits()
        m = self._metrics(w, dt)
        false = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
        flags: Dict[str, torch.Tensor] = {}
        if "max_ramp_up_w_per_s" in m:
            flags["ramp_up"] = m["max_ramp_up_w_per_s"] > lim["ramp_up_w_per_s"]
            flags["ramp_down"] = (m["max_ramp_down_w_per_s"]
                                  > lim["ramp_down_w_per_s"])
        else:
            flags["ramp_up"] = flags["ramp_down"] = false
        if "dynamic_range_w" in m:
            flags["dynamic_range"] = m["dynamic_range_w"] > lim["dynamic_range_w"]
        else:
            flags["dynamic_range"] = false
        material = m["ac_rms_frac"] >= lim["min_ac_rms_frac"]
        flags["band_energy"] = material & (m["band_energy_fraction"]
                                           > lim["max_energy_fraction"])
        if "band_bin_amplitude_w" in m:
            flags["band_amplitude"] = (m["band_bin_amplitude_w"]
                                       > lim["max_bin_amplitude_w"])
        else:
            flags["band_amplitude"] = false
        ok = ~(flags["ramp_up"] | flags["ramp_down"] | flags["dynamic_range"]
               | flags["band_energy"] | flags["band_amplitude"])
        return ok, flags, m


    def loss_jax(self, w: torch.Tensor, dt: float, *, margin: float = 0.0,
                 limits: Optional[Dict[str, float]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Smooth compliance objective of ``w`` ``[B, n]``: ``(total [B],
        components)``, differentiable with respect to ``w``.

        Each component is the squared hinge of a ``validate`` metric's
        normalized excess over its ``(1 - margin)``-shrunk limit: zero on
        (margin-)compliant rows, positive and differentiable outside,
        keyed like the violation flags.  The band-energy materiality gate
        relaxes to a sigmoid, hard-zeroed far below materiality; the
        reductions upstream are ``amax``/``amin``, which share a tie's
        gradient evenly, as ``jnp.max`` does.  ``limits`` overrides the
        thresholds (another same-family spec's ``limits()``).  Rows never
        mix: the gradient of row b's total reaches only row b.
        """
        lims = self.limits() if limits is None else limits
        m = self._metrics(w, dt)
        zero = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)

        def hinge(metric, limit):
            lim = max(float(np.float32(limit)), 1e-30)
            return torch.square(torch.maximum(
                metric / lim - (1.0 - margin), zero))

        comps: Dict[str, torch.Tensor] = {
            "ramp_up": (hinge(m["max_ramp_up_w_per_s"],
                              lims["ramp_up_w_per_s"])
                        if "max_ramp_up_w_per_s" in m else zero),
            "ramp_down": (hinge(m["max_ramp_down_w_per_s"],
                                lims["ramp_down_w_per_s"])
                          if "max_ramp_down_w_per_s" in m else zero),
            "dynamic_range": (hinge(m["dynamic_range_w"],
                                    lims["dynamic_range_w"])
                              if "dynamic_range_w" in m else zero),
        }
        min_frac = max(float(np.float32(lims["min_ac_rms_frac"])), 1e-9)
        material = torch.sigmoid((m["ac_rms_frac"] / min_frac - 1.0) / 0.25)
        # far below materiality the sigmoid's tail would still leak a loss
        # on numerically flat waveforms; the gradient matters near the gate
        material = torch.where(m["ac_rms_frac"] < 0.5 * min_frac, zero,
                               material)
        comps["band_energy"] = material * hinge(m["band_energy_fraction"],
                                                lims["max_energy_fraction"])
        comps["band_amplitude"] = (hinge(m["band_bin_amplitude_w"],
                                         lims["max_bin_amplitude_w"])
                                   if "band_bin_amplitude_w" in m else zero)
        total = sum(comps[v] for v in VIOLATION_ORDER)
        return total, comps


@dataclasses.dataclass(frozen=True)
class SpecReport:
    ok: bool
    violations: Tuple[str, ...]
    metrics: Dict[str, float]


def report_from_arrays(ok, flags: Dict, metrics: Dict) -> SpecReport:
    """Rebuild a SpecReport from one row of ``validate`` outputs."""
    violations = tuple(v for v in VIOLATION_ORDER
                       if v in flags and bool(np.asarray(flags[v])))
    return SpecReport(ok=bool(np.asarray(ok)), violations=violations,
                      metrics={k: float(np.asarray(v))
                               for k, v in metrics.items()})


def example_specs(job_mw: float) -> Dict[str, UtilitySpec]:
    """Representative specs at job scale (paper: '10 MW dynamic range on a
    100 MW job' is the tight case GPU smoothing alone cannot meet)."""
    P = job_mw * 1e6
    return {
        "lenient": UtilitySpec(
            "lenient",
            TimeDomainSpec(ramp_up_w_per_s=0.10 * P, ramp_down_w_per_s=0.10 * P,
                           dynamic_range_w=0.40 * P),
            FrequencyDomainSpec((0.1, 20.0), 0.5)),
        "moderate": UtilitySpec(
            "moderate",
            TimeDomainSpec(ramp_up_w_per_s=0.05 * P, ramp_down_w_per_s=0.05 * P,
                           dynamic_range_w=0.20 * P),
            FrequencyDomainSpec((0.1, 20.0), 0.2)),
        "tight": UtilitySpec(
            "tight",
            TimeDomainSpec(ramp_up_w_per_s=0.02 * P, ramp_down_w_per_s=0.02 * P,
                           dynamic_range_w=0.10 * P),
            FrequencyDomainSpec((0.1, 20.0), 0.1)),
    }
