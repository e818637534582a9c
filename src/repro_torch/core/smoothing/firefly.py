"""Firefly: software-only mitigation (paper Sec. IV-A), hard semantics.

A telemetry-driven controller turns a GEMM ballast on when the measured
chip power drops below an engage threshold and backs it off when the
primary ramps up:

  * telemetry latency, sampling period and noise (``TelemetrySource.
    measure_batch``; the noise of row ``b`` is drawn from its key);
  * a periodic mandatory back-off to re-read activity counters, which
    leaves brief dips;
  * ballast resolution: the burner quantizes to ``ballast_steps``
    intensity steps;
  * interference: ballast overlapping the compute phase costs primary
    throughput, reported as ``perf_overhead``.

The ballast is modelled as arithmetic, as in the reference: this module
never runs the GEMM burner (``kernels/ballast``).  The per-row parameters
are ``engage_frac``, ``threshold_frac`` and ``interference``; telemetry
and back-off timing fix sampling indices and are static.

``smooth_tau > 0`` is the reference's relaxation: the quantizer stays
hard forward with an identity backward (``relax.ste_ceil``), and the
engage gate becomes a sigmoid at temperature tau.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.smoothing.base import energy_overhead, stack_params
from repro_torch.core.smoothing.relax import sigmoid_gate, ste_ceil
from repro_torch.core.telemetry import TelemetrySource


@dataclasses.dataclass(frozen=True)
class Firefly:
    engage_frac: float = 0.85            # fill to this fraction of TDP
    threshold_frac: float = 0.80         # engage when below
    telemetry: TelemetrySource = dataclasses.field(
        default_factory=lambda: TelemetrySource(period_s=0.001,
                                                latency_s=0.002))
    backoff_every_s: float = 0.250       # mandatory counter re-read
    backoff_dur_s: float = 0.004
    ballast_steps: int = 8               # intensity quantization levels
    interference: float = 0.04           # primary slowdown while co-running
    hw: Hardware = DEFAULT_HW
    # 0 = exact hard semantics; > 0 = the design-time relaxation
    smooth_tau: float = 0.0

    STATIC_FIELDS = ("telemetry", "backoff_every_s", "backoff_dur_s",
                     "ballast_steps", "hw", "smooth_tau")
    PARAMS = ("engage_frac", "threshold_frac", "interference")

    @classmethod
    def apply_batch(cls, mits: Sequence["Firefly"], w: torch.Tensor,
                    dt: float, keys: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        m0 = mits[0]
        w = w.to(torch.float32)
        dev = w.device
        p = stack_params(mits, cls.PARAMS, dev)
        tdp = torch.tensor(m0.hw.chip.tdp_w, dtype=torch.float32, device=dev)
        # the reference's float32 arithmetic, operation for operation
        target = (p["engage_frac"] * tdp)[:, None]
        thresh = (p["threshold_frac"] * tdp)[:, None]
        meas = m0.telemetry.measure_batch(w, dt, keys)

        n = w.shape[-1]
        every = max(int(m0.backoff_every_s / dt), 1)
        bdur = max(int(m0.backoff_dur_s / dt), 1)
        backoff = torch.as_tensor((np.arange(n) % every) < bdur, device=dev)

        step_w = target / torch.tensor(float(m0.ballast_steps),
                                       dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if m0.smooth_tau:
            # forward quantized (straight-through ceil); the engage gate
            # relaxes to a sigmoid
            raw = torch.maximum(target - meas, zero)
            ballast = ste_ceil(raw / step_w) * step_w
            ballast = ballast * sigmoid_gate(thresh - meas, m0.smooth_tau,
                                             m0.hw.chip.tdp_w)
        else:
            raw = torch.clamp(target - meas, min=0.0)
            eps = torch.tensor(1e-9, dtype=torch.float32, device=dev)
            ballast = torch.ceil(raw / step_w - eps) * step_w
            ballast = torch.where(meas < thresh, ballast, zero)
        ballast = torch.where(backoff, zero, ballast)
        out = torch.minimum(w + ballast, tdp)

        # interference accounting: ballast active while the primary is busy
        busy = w > thresh
        on = ballast > 0
        n_busy = busy.sum(-1)
        overlap = (busy & on).sum(-1).to(torch.float32)
        perf = torch.where(
            n_busy > 0,
            p["interference"] * overlap
            / torch.clamp(n_busy, min=1).to(torch.float32), zero)
        # summed in float64: the same value on every device
        misfire = torch.where(busy, ballast, zero).to(torch.float64).sum(
            -1) * dt
        return out, {
            "energy_overhead": energy_overhead(w, out),
            "perf_overhead": perf,
            "ballast_duty": (on.sum(-1).to(torch.float64) / n
                             ).to(torch.float32),
            "reaches_tdp_frac": out.amax(-1) / tdp,
            "misfire_j": misfire.to(torch.float32),
        }
