"""Telemetry stream sources for the grid-interactive control plane.

The control loop consumes any ``TelemetrySource``: an object that hands
out power samples one control tick at a time and accepts dispatched
interventions that reshape its *future* samples.  ``ReplaySource``
replays a recorded or synthesized waveform (``synthesize_ramp`` below),
chunked at a configurable control tick, and applies interventions to the
not-yet-streamed suffix, so a dispatch at tick t changes what the
detector sees from tick t+1 on, as capping or re-configuring a live
fleet would.

The source is the telemetry archive and stays host numpy; the detector
moves each chunk to its own device.  Distinct from
``core.telemetry.TelemetrySource`` (the sensor *model*: period, latency,
noise, quantization), which can be attached here to degrade the replayed
stream the same way.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core import telemetry as core_telemetry


@runtime_checkable
class TelemetrySource(Protocol):
    """What the control loop needs from a stream: tick-sized chunks of
    power samples and a way to re-shape the future when it dispatches."""
    dt: float

    def next_tick(self) -> Optional[np.ndarray]:
        """Next chunk of power samples, or None when the stream ends."""
        ...

    def apply_interventions(self, interventions: Sequence) -> None:
        """Replace the active intervention set (applied to future samples)."""
        ...


class ReplaySource:
    """Replay a waveform as a control-tick stream with closed-loop physics.

    ``tick_s`` fixes the default chunk size; ``tick_sizes`` (sample
    counts) overrides the first ticks, falling back to the default
    afterwards.  ``sensor`` optionally degrades chunks through the
    ``core.telemetry.TelemetrySource`` sensor model.

    Interventions are composed over the *pristine* future: each
    ``apply_interventions`` call recomputes ``raw[cursor:]`` through the
    current transform stack, so releasing an intervention removes its
    effect rather than leaving it baked in.
    """

    def __init__(self, w: np.ndarray, dt: float, *, tick_s: float = 0.5,
                 tick_sizes: Optional[Iterable[int]] = None,
                 sensor: Optional["core_telemetry.TelemetrySource"] = None,
                 seed: int = 0):
        self.raw = np.array(w, np.float32)
        self._w = self.raw.copy()
        self.dt = float(dt)
        self._tick_n = max(int(round(tick_s / dt)), 1)
        self._tick_sizes = list(tick_sizes) if tick_sizes is not None else []
        self.sensor = sensor
        self.seed = seed
        self.cursor = 0
        self.tick = 0
        self.active: List = []

    @property
    def n(self) -> int:
        return int(self.raw.shape[0])

    def next_tick(self) -> Optional[np.ndarray]:
        if self.cursor >= self.n:
            return None
        k = (self._tick_sizes[self.tick] if self.tick < len(self._tick_sizes)
             else self._tick_n)
        chunk = self._w[self.cursor:self.cursor + k]
        if self.sensor is not None:
            chunk = self.sensor.measure(np.asarray(chunk, np.float64),
                                        self.dt,
                                        seed=self.seed + self.tick)
            chunk = chunk.astype(np.float32)
        self.cursor += len(chunk)
        self.tick += 1
        return chunk

    def apply_interventions(self, interventions: Sequence) -> None:
        self.active = list(interventions)
        future = self.raw[self.cursor:].copy()
        if not len(future):
            return
        for iv in interventions:
            future = np.asarray(iv.transform(future, self.dt), np.float32)
        self._w[self.cursor:] = future

    def history(self, n_samples: int) -> np.ndarray:
        """The last ``n_samples`` already-streamed (post-intervention)
        samples: what a live fleet's telemetry archive would hold."""
        return self._w[max(0, self.cursor - n_samples):self.cursor]

    def observed(self) -> np.ndarray:
        """Everything streamed so far (post-intervention)."""
        return self._w[:self.cursor]


def synthesize_ramp(*, dc_w: float = 5e8, f_hz: float = 9.0,
                    peak_amp_w: float = 8e7, duration_s: float = 48.0,
                    ramp_start_s: float = 8.0, ramp_end_s: float = 32.0,
                    dt: float = 0.002, noise_w: float = 0.0,
                    seed: int = 0) -> np.ndarray:
    """The canonical control-plane trace: a fleet-scale DC operating
    point with an ``f_hz`` oscillation whose amplitude ramps linearly
    from zero (at ``ramp_start_s``) to ``peak_amp_w`` (at ``ramp_end_s``)
    and then holds: the slow drift toward a grid-critical breach the
    controller must catch before it crosses the spec threshold."""
    n = int(round(duration_s / dt))
    t = np.arange(n) * dt
    env = peak_amp_w * np.clip((t - ramp_start_s)
                               / max(ramp_end_s - ramp_start_s, dt), 0.0, 1.0)
    w = dc_w + env * np.sin(2.0 * np.pi * f_hz * t)
    if noise_w > 0:
        rng = np.random.default_rng(seed)
        w = w + rng.normal(0.0, noise_w, size=n)
    return w.astype(np.float32)
