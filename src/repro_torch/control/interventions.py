"""The intervention ladder: what the controller dispatches, per level.

Each rung produces an ``Intervention``: a named, parameterized transform
over the fleet's *future* power trace (what a ``ReplaySource`` applies to
its not-yet-streamed suffix; on a live fleet the same three knobs are
config pushes):

  level 1  redesign   re-run the ``design()`` grid search on the recent
                      observed history (its AC component scaled by a
                      headroom factor, so the config covers where the
                      trend is going) and apply the winning device + rack
                      mitigation pair exactly as the design search
                      evaluates candidates (kernels B and C).
  level 2  power cap  clamp the aggregate into a band around the
                      operating point tight enough that the residual bin
                      amplitude sits below the release level; the trough
                      side is backed by a Firefly ballast sized by
                      ``ballast_gflops_for_floor``.
  level 3  stagger    phase-stagger job groups with a ``1/(G*f)`` comb of
                      start offsets (a ``StaggerSchedule``), which nulls
                      the offending bin: sum_g e^{-2 pi i f g/(G f)} = 0.

Rungs are cumulative: level 2 holds both the redesign and the cap.  The
transforms run on the ladder's device (``device=None``: the card) and
hand numpy back to the source.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.ballast_inject import ballast_gflops_for_floor
from repro_torch.core.engine import design
from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.smoothing.base import apply_mitigation
from repro_torch.core.stagger import StaggerSchedule
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Intervention:
    """A dispatched action: a transform over future aggregate power plus
    a JSON-safe parameter summary for the ``ControlLog``."""
    name: str
    params: Dict
    transform: Callable[[np.ndarray, float], np.ndarray]
    build_latency_s: float = 0.0


def _on(device, future) -> torch.Tensor:
    return torch.as_tensor(np.asarray(future, np.float32), device=device)


def redesign_intervention(spec, history_w: np.ndarray, dt: float,
                          n_chips: int, *, hw: Hardware = DEFAULT_HW,
                          method: str = "grid", warmstart=None,
                          headroom: float = 1.25, device=None
                          ) -> Optional[Intervention]:
    """Rung 1: mitigation re-design on observed history.

    The design target is the history with its AC component scaled by
    ``headroom``.  Returns None when the design finds no feasible config
    or a do-nothing one (the controller escalates to the next rung on
    its own)."""
    dev = resolve_device(device)
    w = np.asarray(history_w, np.float32)
    mean = float(w.mean())
    target = (mean + headroom * (w - mean)).astype(np.float32)
    kw = {} if warmstart is None else {"warmstart": warmstart}
    t0 = time.perf_counter()
    sol = design(spec, target, dt, n_chips, method=method, hw=hw,
                 device=dev, **kw)
    latency = time.perf_counter() - t0
    if sol is None:
        return None
    gpu = sol.get("device_mitigation")
    bat = sol.get("rack_mitigation")
    if gpu is None and bat is None:
        return None

    def transform(future: np.ndarray, dt_: float) -> np.ndarray:
        out = _on(dev, future)[None]
        if gpu is not None:
            # per-chip device mitigation, as the design search applies it
            chips = torch.tensor(float(n_chips), dtype=torch.float32,
                                 device=dev)
            out = apply_mitigation([gpu], out / chips, dt_)[0] * chips
        if bat is not None:
            out = apply_mitigation([bat], out, dt_)[0]
        return out[0].cpu().numpy()

    return Intervention(
        name="redesign",
        params={"mpf_frac": float(sol.get("mpf_frac") or 0.0),
                "battery_capacity_j": float(sol.get("battery_capacity_j")
                                            or 0.0),
                "energy_overhead": float(sol.get("energy_overhead", 0.0)),
                "method": sol.get("method", method),
                "headroom": headroom},
        transform=transform, build_latency_s=latency)


def power_cap_intervention(history_w: np.ndarray, dt: float, *,
                           release_amp_w: float, n_chips: int,
                           hw: Hardware = DEFAULT_HW,
                           band_frac: float = 0.5,
                           device=None) -> Intervention:
    """Rung 2: clamp the aggregate into ``mean +- band_frac*release_amp_w``.

    A hard clamp turns a large oscillation into a square-ish residual
    whose fundamental is ``4/pi`` times the half-band, so
    ``band_frac=0.5`` keeps the residual bin amplitude at most
    ``0.64 * release_amp_w``.  The floor side is what the Firefly ballast
    provides; its size is reported in the params."""
    dev = resolve_device(device)
    w = np.asarray(history_w, np.float64)
    mean = float(w.mean())
    half_band = band_frac * float(release_amp_w)
    cap_w = mean + half_band
    floor_w = mean - half_band
    gflops = ballast_gflops_for_floor(w, dt, floor_w, n_chips, hw=hw)

    def transform(future: np.ndarray, dt_: float) -> np.ndarray:
        return torch.clamp(_on(dev, future), min=float(np.float32(floor_w)),
                           max=float(np.float32(cap_w))).cpu().numpy()

    return Intervention(
        name="power_cap",
        params={"cap_w": cap_w, "floor_w": floor_w,
                "ballast_gflops": float(gflops)},
        transform=transform)


def stagger_intervention(f_hz: float, dt: float, *, n_groups: int = 4,
                         history_w: Optional[np.ndarray] = None,
                         device=None) -> Intervention:
    """Rung 3: phase-stagger ``n_groups`` job groups by a ``1/(G*f)``
    offset comb (a ``StaggerSchedule``), decohering the offending bin.

    The aggregate becomes the mean of time-shifted replicas (edge-padded,
    like ``waveform.aggregate``), summed in group order; at ``f_hz`` the
    comb factor ``|sum_g e^{-2 pi i f g/(G f)}| / G`` is exactly zero, and
    ``comb_attenuation`` gives the residual at any other frequency."""
    dev = resolve_device(device)
    G = max(int(n_groups), 2)
    offsets = np.arange(G) / (G * float(f_hz))
    shifts = np.round(offsets / dt).astype(np.int64)
    atten = float(abs(np.exp(-2j * np.pi * f_hz * offsets).mean()))
    if history_w is not None and len(history_w):
        ramp = float(np.ptp(np.asarray(history_w, np.float64)) / G
                     / max(float(offsets[1]), dt))
    else:
        ramp = 0.0
    sched = StaggerSchedule(offsets_s=offsets.astype(np.float64),
                            rack_ramp_w_per_s=ramp)

    def transform(future: np.ndarray, dt_: float) -> np.ndarray:
        n = len(future)
        if n == 0:
            return future
        x = _on(dev, future)
        pos = torch.arange(n, device=dev)
        acc = None
        for s in shifts.tolist():
            rep = x[torch.clamp(pos - s, min=0)]
            acc = rep if acc is None else acc + rep
        return (acc / torch.tensor(float(G), device=dev)).cpu().numpy()

    return Intervention(
        name="stagger",
        params={"f_hz": float(f_hz), "n_groups": G,
                "offsets_s": [float(o) for o in offsets],
                "comb_attenuation": atten,
                "total_s": sched.total_s},
        transform=transform)


class InterventionLadder:
    """Level -> cumulative intervention stack, with per-level caching so a
    re-dispatch at a higher level doesn't re-run lower rungs' solvers."""

    RUNGS = ("redesign", "power_cap", "stagger")

    def __init__(self, *, spec, n_chips: int, dt: float,
                 release_amp_w: float, hw: Hardware = DEFAULT_HW,
                 design_method: str = "grid", warmstart=None,
                 headroom: float = 1.25, stagger_groups: int = 4,
                 device=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.n_chips = int(n_chips)
        self.dt = float(dt)
        self.release_amp_w = float(release_amp_w)
        self.hw = hw
        self.design_method = design_method
        self.warmstart = warmstart
        self.headroom = headroom
        self.stagger_groups = int(stagger_groups)
        self._cache: Dict[int, Optional[Intervention]] = {}

    def build(self, rung: int, history_w: np.ndarray,
              f_hz: float) -> Optional[Intervention]:
        """Build (or fetch) the intervention for ladder rung 1..3,
        measuring wall-clock build latency."""
        if rung in self._cache:
            return self._cache[rung]
        t0 = time.perf_counter()
        if rung == 1:
            iv = redesign_intervention(
                self.spec, history_w, self.dt, self.n_chips, hw=self.hw,
                method=self.design_method, warmstart=self.warmstart,
                headroom=self.headroom, device=self.device)
        elif rung == 2:
            iv = power_cap_intervention(
                history_w, self.dt, release_amp_w=self.release_amp_w,
                n_chips=self.n_chips, hw=self.hw, device=self.device)
        else:
            iv = stagger_intervention(f_hz, self.dt,
                                      n_groups=self.stagger_groups,
                                      history_w=history_w,
                                      device=self.device)
        if iv is not None:
            iv.build_latency_s = time.perf_counter() - t0
        self._cache[rung] = iv
        return iv

    def release(self, rung: int) -> None:
        """Forget a rung's cached config so a future re-escalation
        re-solves against fresh history."""
        self._cache.pop(rung, None)
