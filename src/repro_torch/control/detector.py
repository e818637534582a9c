"""Online sliding-Goertzel detector: the offline monitor, run per tick.

``OnlineGoertzelDetector`` runs the *fused* monitor by default
(``fused=True``): each ``step(chunk)`` consumes one control tick of
samples through ``sliding_monitor_fused(..., carry=)``: kernel A reduces
per-bin amplitudes to the per-sample worst bin and its escalation class,
kernel D advances the shared escalation machine, and the per-bin
amplitudes the controller consumes are recombined in O(K) from the
streamed prefix state, so no ``[m, K]`` amplitude block exists.  The
per-sample worst stream and escalation level ride along in the frame.

``fused=False`` selects the amplitude-emitting path on kernel E
(``sliding_bin_power(..., carry=)``): every per-sample per-bin amplitude
is emitted (``frame.tick_amps``), bit for bit one offline
``sliding_bin_power`` call on the concatenated trace.

Chunks go to the detector's device (``device=None``: the card); each
tick reads back one small block (the tick's worst stream, the last
per-bin amplitudes and the level), so frames are host numpy.  On top of
the amplitudes the detector keeps per-bin trend slopes over a short
trailing horizon: the signal the controller's slope-based early warning
projects forward to act before a breach.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.goertzel.ops import (monitor_carry_init,
                                              sliding_bin_power,
                                              sliding_carry_init,
                                              sliding_monitor_fused)


@dataclasses.dataclass
class DetectorFrame:
    """One tick of detector output, consumed by ``GridController``."""
    tick: int
    t_s: float                 # time of the tick's last sample
    sample_idx: int            # global index of the tick's last sample
    amps: np.ndarray           # [K] bin amplitudes at the last sample
    slopes: np.ndarray         # [K] amplitude trend, W/s
    warm: bool                 # one full window has streamed
    # amplitude-emitting path (fused=False) only:
    tick_amps: Optional[np.ndarray] = None   # [m, K] per-sample amplitudes
    # fused path (fused=True) only:
    tick_worst: Optional[np.ndarray] = None  # [m] per-sample worst-bin amp
    level: int = 0             # shared escalation machine's level after tick


class OnlineGoertzelDetector:
    """Incremental per-bin amplitude monitor with trend estimation.

    ``mean`` is the DC operating point removed before accumulation (see
    ``sliding_carry_init``); ``slope_window_s`` bounds the trailing
    horizon the per-bin slope is estimated over (endpoint difference of
    tick-end amplitudes).  ``threshold_w``/``release_w``/``sustain_s``/
    ``cooldown_s`` configure the fused path's shared escalation machine
    (default threshold ``+inf``: the machine idles).
    """

    def __init__(self, dt: float, freqs: Sequence[float], *,
                 window_s: float = 4.0, mean: float = 0.0,
                 slope_window_s: Optional[float] = None,
                 fused: bool = True, threshold_w: Optional[float] = None,
                 release_w: Optional[float] = None,
                 sustain_s: float = 1.0, cooldown_s: float = 2.0,
                 max_level: int = 3, device=None):
        self.device = resolve_device(device)
        self.dt = float(dt)
        self.freqs = tuple(float(f) for f in freqs)
        self.win = max(int(window_s / dt), 8)
        self.fused = bool(fused)
        self.threshold_w = float(threshold_w if threshold_w is not None
                                 else np.inf)
        self.release_w = float(release_w if release_w is not None
                               else self.threshold_w)
        self.sustain_n = max(int(sustain_s / dt), 1)
        self.cool_n = max(int(cooldown_s / dt), 1)
        self.max_level = int(max_level)
        init = monitor_carry_init if self.fused else sliding_carry_init
        self.carry = init(self.dt, self.freqs, win=self.win, mean=mean,
                          device=self.device)
        horizon = slope_window_s if slope_window_s is not None else window_s / 2
        self._hist: Deque[Tuple[float, np.ndarray]] = collections.deque()
        self._horizon_s = max(float(horizon), self.dt)
        self._tick = 0

    @property
    def n_bins(self) -> int:
        return len(self.freqs)

    def step(self, chunk: np.ndarray) -> DetectorFrame:
        x = torch.as_tensor(np.asarray(chunk, np.float32),
                            device=self.device)
        m, K = x.shape[0], self.n_bins
        tick_amps = tick_worst = None
        if self.fused:
            worst, levels, latest, self.carry = sliding_monitor_fused(
                x, self.dt, self.freqs, win=self.win,
                threshold=self.threshold_w, release=self.release_w,
                sustain_n=self.sustain_n, cool_n=self.cool_n,
                max_level=self.max_level, carry=self.carry)
            last_level = levels[-1:] if m else self.carry.esc[0, :1]
            # one read-back per tick: worst stream, last amplitudes, level
            host = torch.cat([worst, latest,
                              last_level.to(torch.float32)]).cpu().numpy()
            tick_worst, latest = host[:m], host[m:m + K]
            level = int(host[-1])
            offset = self.carry.sliding.offset
        else:
            amps, self.carry = sliding_bin_power(x, self.dt, self.freqs,
                                                 win=self.win,
                                                 carry=self.carry)
            tick_amps = amps.cpu().numpy()
            latest = (tick_amps[-1] if m else np.zeros(K, np.float32))
            level = 0
            offset = self.carry.offset
        last_idx = offset - 1
        t_s = last_idx * self.dt
        self._hist.append((t_s, latest))
        while (len(self._hist) > 2
               and t_s - self._hist[0][0] > self._horizon_s):
            self._hist.popleft()
        t0, a0 = self._hist[0]
        span = t_s - t0
        slopes = ((latest - a0) / span if span > 0
                  else np.zeros(K, np.float32))
        frame = DetectorFrame(tick=self._tick, t_s=t_s, sample_idx=last_idx,
                              amps=np.asarray(latest, np.float32),
                              slopes=np.asarray(slopes, np.float32),
                              warm=last_idx >= self.win - 1,
                              tick_amps=tick_amps, tick_worst=tick_worst,
                              level=level)
        self._tick += 1
        return frame
