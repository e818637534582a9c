"""The float64 oracle of the sliding-Goertzel monitor.

``sliding_bin_power_ref`` gives every-sample sliding-window bin
amplitudes ``[n, K]`` in numpy float64: the trace mean is removed before
accumulating and the accumulation is exact at any trace length, so the
monitor kernel and its plain version are held against it.
"""
from __future__ import annotations

import numpy as np


def sliding_bin_power_ref(x: np.ndarray, dt: float, freqs, win: int
                          ) -> np.ndarray:
    """Every-sample sliding-window bin amplitudes [n, K] (numpy float64:
    mean-removed and exactly accumulated)."""
    x = np.asarray(x, np.float64)
    xc = x - x.mean()
    n = len(xc)
    out = np.zeros((n, len(freqs)))
    t = np.arange(n) * dt
    denom = np.minimum(np.arange(n) + 1, win)
    for j, f in enumerate(freqs):
        cs = np.cumsum(xc * np.exp(-2j * np.pi * f * t))
        w = cs.copy()
        w[win:] = cs[win:] - cs[:-win]
        out[:, j] = 2.0 * np.abs(w) / denom
    return out
