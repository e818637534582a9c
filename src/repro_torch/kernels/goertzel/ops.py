"""The offline sliding monitor: trace -> worst-bin amplitude, escalation
levels, first detection and per-segment per-bin peaks.

``sliding_monitor_fused`` centres each row on its float64 mean, cuts it
into window-sized segments (zero-padding the tail), runs the fused
monitor (kernel A, ``monitor.sliding_monitor``) and folds the escalation
machine over the class stream (kernel D, ``core.telemetry.
escalation_scan``).  The ``[n, K]`` amplitude matrix never exists.

The mean is taken in float64 and subtracted before the cast to float32:
the float32 mean of a 5e8 W trace is hundreds of watts off, and that
error reads as signal in every bin.  The online carry API
(``SlidingCarry``/``MonitorCarry``) is not ported yet.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.telemetry import escalation_init, escalation_scan
from repro_torch.kernels.goertzel.monitor import sliding_monitor


@functools.lru_cache(maxsize=None)
def phase_tables(freqs: Tuple[float, ...], dt: float, win: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-float64 phase tables cast to float32: ``cosp``/``sinp``
    ``[K, win]`` of ``w_k p`` and the segment rotation ``[K, 2]`` =
    [cos, sin] of ``w_k win``, with ``w_k = 2 pi f_k dt``."""
    omega = 2.0 * np.pi * np.asarray(freqs, np.float64) * dt
    p = np.arange(win, dtype=np.float64)[None, :]
    cosp = np.cos(omega[:, None] * p).astype(np.float32)
    sinp = np.sin(omega[:, None] * p).astype(np.float32)
    rot = np.stack([np.cos(omega * win),
                    np.sin(omega * win)], axis=1).astype(np.float32)
    return cosp, sinp, rot


def centre(x: torch.Tensor) -> torch.Tensor:
    """``x`` ``[B, n]`` minus its row means, both in float64, as float32."""
    x64 = x.to(torch.float64)
    return (x64 - x64.mean(-1, keepdim=True)).to(torch.float32)


def segments(xc: torch.Tensor, win: int) -> torch.Tensor:
    """``[B, n]`` -> ``[B, S, win]``, the tail zero-padded."""
    B, n = xc.shape
    S = -(-n // win)
    return torch.nn.functional.pad(xc, (0, S * win - n)).reshape(B, S, win)


def sliding_monitor_fused(x: torch.Tensor, dt: float, freqs: Sequence[float],
                          *, win: int, threshold, sustain_n: int,
                          cool_n: int, max_level: int = 3, release=None):
    """The fused sliding monitor over the rows of ``x`` ``[B, n]``.

    ``threshold`` (and ``release``, default ``threshold``) is a float or a
    per-row ``[B]`` tensor.  Returns ``(worst [B, n] f32, levels [B, n]
    int8, detect [B] int64, peaks [B, S, K] f32)``: the per-sample
    worst-bin amplitude, the escalation level (sustain/cool hysteresis,
    warm-up and pad gated), the first escalation's sample index (-1 if
    none) and the per-segment per-bin peak amplitudes over live samples.
    """
    B, n = x.shape
    dev = x.device
    cosp, sinp, rot = (torch.as_tensor(t, device=dev)
                       for t in phase_tables(tuple(freqs), float(dt), win))
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=dev).expand(B).contiguous()
    rel = (thr if release is None else
           torch.as_tensor(release, dtype=torch.float32,
                           device=dev).expand(B).contiguous())
    zeros = torch.zeros((B, len(freqs), win), dtype=torch.float32,
                        device=dev)
    xseg = segments(centre(x), win)
    worst, cls, peaks, _, _ = sliding_monitor(
        xseg, cosp, sinp, rot, thr, rel,
        torch.full((B,), n, dtype=torch.int64, device=dev),
        torch.zeros(B, dtype=torch.int64, device=dev), zeros, zeros)
    carry, levels = escalation_scan(
        cls.reshape(B, -1)[:, :n].contiguous(), 0,
        escalation_init(B, dev), sustain_n=sustain_n, cool_n=cool_n,
        max_level=max_level)
    return worst.reshape(B, -1)[:, :n], levels, carry[:, 3], peaks
