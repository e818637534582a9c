"""The float64 oracles of the Goertzel kernels.

``goertzel_ref`` runs the windowed Goertzel recurrence of kernel H in
numpy float64 on the given coefficients, and ``bin_power_recurrence_ref``
runs it on a trace as ``ops.bin_power`` does; ``bin_power_ref`` is the
per-window DFT-bin amplitude by direct correlation, the definition the
recurrence implements.  ``sliding_bin_power_ref`` gives every-sample
sliding-window bin amplitudes ``[n, K]``: the trace mean is removed
before accumulating and the accumulation is exact at any trace length,
so the monitor kernels and their plain versions are held against it.
"""
from __future__ import annotations

import numpy as np


def goertzel_ref(windows, coef) -> np.ndarray:
    """windows ``[W, win]``, coef ``[K]`` = 2 cos(2 pi f dt) -> amplitudes
    ``[W, K]``: the kernel's recurrence and terminal formula in float64."""
    x = np.asarray(windows, np.float64)
    coef = np.asarray(coef, np.float64)
    W, win = x.shape
    s1 = np.zeros((W, len(coef)))
    s2 = np.zeros_like(s1)
    for t in range(win):
        s1, s2 = x[:, t, None] + coef[None, :] * s1 - s2, s1
    power = s1 * s1 + s2 * s2 - coef[None, :] * s1 * s2
    return (2.0 / win) * np.sqrt(np.maximum(power, 0.0))


def centred_windows(x, win: int):
    """float64 windows ``[ceil(n/win), win]`` of the trace ``x``, each
    minus its own mean over its true sample count, the tail zero-padded;
    and the counts ``[W]``."""
    x = np.asarray(x, np.float64)
    n = len(x)
    W = -(-n // win)
    counts = np.full(W, win)
    counts[-1] = n - (W - 1) * win
    wnd = np.zeros((W, win))
    for i in range(W):
        seg = x[i * win:i * win + counts[i]]
        wnd[i, :counts[i]] = seg - seg.mean()
    return wnd, counts


def bin_power_recurrence_ref(x, coef, win: int) -> np.ndarray:
    """``ops.bin_power`` in float64: ``goertzel_ref`` on the trace's
    ``centred_windows`` with the given coefficients, each window's
    amplitudes rescaled by win / its count."""
    wnd, counts = centred_windows(x, win)
    return goertzel_ref(wnd, coef) * (win / counts)[:, None]


def bin_power_ref(windows, dt: float, freqs) -> np.ndarray:
    """windows ``[W, win]``, freqs ``[K]`` Hz -> amplitudes ``[W, K]`` by
    direct correlation with the bins' phasors, in float64."""
    x = np.asarray(windows, np.float64)
    win = x.shape[1]
    t = (np.arange(win)[:, None] * (2 * np.pi * dt)
         * np.asarray(freqs, np.float64)[None, :])
    re = x @ np.cos(t)
    im = x @ np.sin(t)
    return (2.0 / win) * np.sqrt(re * re + im * im)


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
