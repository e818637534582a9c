"""Frequency-domain analysis of power waveforms (paper Fig. 3, Sec. III).

Every function takes a batch of same-length waveforms ``[B, n]`` and
returns one value per row, on one FFT of the Hann-windowed AC component
(float32, as in the reference).  Band edges and ``dt`` select FFT bins on
the host.  The streaming per-bin monitor the backstop runs lives in
``kernels/goertzel``.

A row's values do not depend on the other rows of its batch, nor on its
place there, on the card as on the CPU:

- for an odd ``n`` the card's batched ``rfft`` computes two rows in one
  transform, so a row's spectrum took bits from its neighbour; an odd
  ``n`` takes the complex FFT of each row instead (its first ``n // 2 +
  1`` bins);
- the card's sums over a row's last axis take their order from the row's
  address modulo 16 bytes, so every summed tensor is laid out with a row
  stride of a multiple of four elements (``_row_aligned``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# the grid-critical probe frequencies: inter-area (<1 Hz), plant-coupling
# (1-2.5 Hz), the paper band's center, and low torsional bins; the bins
# the control plane's online detector watches
GRID_CRITICAL_HZ = (0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 9.0)


def goertzel_bin_amplitudes(x: np.ndarray, dt: float,
                            freqs: Tuple[float, ...] = GRID_CRITICAL_HZ
                            ) -> np.ndarray:
    """Single-bin DFT amplitudes (watts) of the AC component of one trace
    at ``freqs``, in float64 numpy: the sliding monitor's Goertzel sums
    collapsed to one window over the whole trace, with no Hann window (a
    sine of amplitude A at a bin's frequency reports about A).  The
    warm-start predictor's spectral fingerprint (``serve/warmstart.py``);
    the reference's numpy function, operation for operation."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n == 0:
        return np.zeros(len(freqs))
    xac = x - x.mean()
    t = np.arange(n) * dt
    phases = np.exp(-2j * np.pi * np.asarray(freqs)[:, None] * t[None, :])
    return np.abs(phases @ xac) * 2.0 / n


def goertzel_bin_amplitudes_torch(x: torch.Tensor, dt: float,
                                  freqs: Tuple[float, ...] = GRID_CRITICAL_HZ
                                  ) -> torch.Tensor:
    """``goertzel_bin_amplitudes`` in float32 on ``x``'s device, for one
    trace ``[n]``: the phase table is built on the host in float64 and
    cast, as in the reference's jnp mirror."""
    x = torch.as_tensor(x).to(torch.float32)
    n = x.shape[-1]
    xac = x - x.mean()
    t = np.arange(n) * dt
    ph = np.exp(-2j * np.pi * np.asarray(freqs)[:, None] * t[None, :])
    re = torch.as_tensor(ph.real, dtype=torch.float32, device=x.device) @ xac
    im = torch.as_tensor(ph.imag, dtype=torch.float32, device=x.device) @ xac
    return torch.sqrt(re * re + im * im) * 2.0 / n


def row_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` ``[..., m]`` (same values) laid out with a row stride of a
    multiple of four elements, so that every row starts at one alignment
    and a reduction over the last axis sums each row in one order."""
    pad = (-x.shape[-1]) % 4
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, pad))[..., :x.shape[-1]]


def spectrum(x: torch.Tensor, dt: float) -> Tuple[np.ndarray, torch.Tensor]:
    """One-sided amplitude spectrum ``[B, n//2 + 1]`` of the AC component,
    with its bin frequencies (host numpy)."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    xac = x - x.to(torch.float64).mean(-1, keepdim=True).to(torch.float32)
    hann = torch.as_tensor(np.hanning(n), dtype=torch.float32,
                           device=x.device)
    if n % 2:
        spec = torch.fft.fft((xac * hann).to(torch.complex64),
                             dim=-1)[..., :n // 2 + 1]
    else:
        spec = torch.fft.rfft(xac * hann, dim=-1)
    mag = spec.abs() * 2.0 / n
    return np.fft.rfftfreq(n, dt), mag


def _band_mask(freqs: np.ndarray, f_lo: float, f_hi: float) -> np.ndarray:
    sel = (freqs >= f_lo) & (freqs <= f_hi)
    sel[0] = False  # DC is not part of the AC energy budget
    return sel


def _bins(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host bin mask -> index tensor (a boolean index on the device would
    wait for the device to count the hits)."""
    return torch.as_tensor(np.flatnonzero(mask), device=like.device)


def _band_fraction(e: torch.Tensor, tot: torch.Tensor, freqs: np.ndarray,
                   f_lo: float, f_hi: float) -> torch.Tensor:
    band = e.index_select(-1, _bins(_band_mask(freqs, f_lo, f_hi), e))
    val = row_aligned(band).sum(-1) / torch.clamp(tot, min=1e-30)
    return torch.where(tot > 0, val, torch.zeros_like(val))


def band_energy_fraction(x: torch.Tensor, dt: float,
                         f_lo: float, f_hi: float) -> torch.Tensor:
    """Fraction of total AC spectral energy inside [f_lo, f_hi]."""
    freqs, mag = spectrum(x, dt)
    e = row_aligned(mag ** 2)
    return _band_fraction(e, e[:, 1:].sum(-1), freqs, f_lo, f_hi)


def band_amplitude_w(x: torch.Tensor, dt: float,
                     f_lo: float, f_hi: float) -> torch.Tensor:
    """Peak single-bin amplitude (watts) inside the band."""
    freqs, mag = spectrum(x, dt)
    sel = (freqs >= f_lo) & (freqs <= f_hi)
    if not sel.any():
        return torch.zeros(mag.shape[0], device=mag.device)
    return mag.index_select(-1, _bins(sel, mag)).amax(-1)


def dominant_frequency(x: torch.Tensor, dt: float) -> torch.Tensor:
    freqs, mag = spectrum(x, dt)
    return _dominant(freqs, mag)


def _dominant(freqs: np.ndarray, mag: torch.Tensor) -> torch.Tensor:
    if len(freqs) < 2:
        return torch.zeros(mag.shape[0], device=mag.device)
    f = torch.as_tensor(freqs, dtype=torch.float32, device=mag.device)
    return f[1:][torch.argmax(mag[:, 1:], dim=-1)]


def critical_band_report(x: torch.Tensor, dt: float
                         ) -> Dict[str, torch.Tensor]:
    """The paper's bands: <1 Hz (inter-area), 1-2.5 Hz (plant coupling),
    7-100 Hz (shaft torsional), on one rfft per row."""
    freqs, mag = spectrum(x, dt)
    e = row_aligned(mag ** 2)
    tot = e[:, 1:].sum(-1)
    return {
        "sub_1hz": _band_fraction(e, tot, freqs, 0.05, 1.0),
        "plant_1_2p5hz": _band_fraction(e, tot, freqs, 1.0, 2.5),
        "torsional_7_100hz": _band_fraction(e, tot, freqs, 7.0, 100.0),
        "paper_band_0p2_3hz": _band_fraction(e, tot, freqs, 0.2, 3.0),
        "dominant_hz": _dominant(freqs, mag),
    }
