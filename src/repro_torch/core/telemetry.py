"""Shared monitor gating: the warm-up ramp and the escalation state
machine of the telemetry backstop (paper Sec. IV-A/E).

``escalation_classify`` reduces a monitored amplitude to a sample class;
``escalation_class_step`` is one transition of the threshold-with-
hysteresis machine on a class; ``escalation_scan`` folds the machine over
a batch of class streams ``[B, n]``.  On a CUDA tensor the fold runs as
kernel D (``kernels/scans/csrc/escalation.cu``, one warp per row, the
stream staged through shared memory, the counters in int32 where
``escalation_fits_int32`` holds and in int64 elsewhere); on a CPU tensor
it runs ``escalation_scan_plain``, a Python loop over samples of
``escalation_class_step``.

The carry is an int64 ``[B, 4]`` tensor ``(level, above, below,
detect)``; sample indices are int64, so ``detect`` is exact at any trace
length.  ``escalation_step`` is one amplitude-facing step on the carry
as a tuple of tensors (the control plane's per-tick controller).

``TelemetrySource`` is the sensor model (sampling period, read-out
latency, noise, quantization): ``measure`` on numpy with the reference's
numpy random draws, and ``measure_batch``, the reference's ``measure_jax``
on a batch of rows ``[B, n]``, its noise drawn from per-row keys by
``core/prng.py`` (the draws ``jax.random.normal`` gives for those keys).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

#: escalation sample classes.  CLS_PAD is the identity transition.
CLS_CLEAR, CLS_BAND, CLS_HIT, CLS_PAD = 0, 1, 2, 3

ESCALATION_KERNEL = CudaKernel(
    "scans/csrc/escalation.cu", "escalation_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p])


def warmup_scale(idx: torch.Tensor, win: int) -> torch.Tensor:
    """The sliding monitor's warm-up renormalization ``win / min(i+1, win)``
    at global sample index ``idx`` (any integer dtype), in float32."""
    denom = torch.clamp(idx + 1, max=win).to(torch.float32)
    # a true division: ``float / tensor`` would multiply by the reciprocal
    return torch.div(torch.tensor(float(win), device=denom.device), denom)


def escalation_init(rows: int, device=None) -> torch.Tensor:
    """Initial carry ``[rows, 4]``: level 0, counters 0, detect -1."""
    carry = torch.zeros((rows, 4), dtype=torch.int64, device=device)
    carry[:, 3] = -1
    return carry


def escalation_classify(amp: torch.Tensor, idx: torch.Tensor, *,
                        threshold, win: int, n, release=None
                        ) -> torch.Tensor:
    """Sample class (int8): 2 above ``threshold`` and live, 0 at or below
    ``release`` (default ``threshold``) or not live, 1 in between.  Live
    means ``win - 1 <= idx < n``.  ``threshold``/``release`` broadcast
    against ``amp``; ``release <= threshold`` is required."""
    live = (idx >= win - 1) & (idx < n)
    hit = (amp > threshold) & live
    rel = threshold if release is None else release
    clear = ~((amp > rel) & live)
    band = ~hit & ~clear
    return (2 * hit.to(torch.int32) + band.to(torch.int32)).to(torch.int8)


def escalation_class_step(carry, cls: torch.Tensor, idx: torch.Tensor, *,
                          sustain_n: int, cool_n: int, max_level: int = 3):
    """One transition of every row's machine.  ``carry`` is the tuple
    ``(level, above, below, detect)`` of int64 ``[B]`` tensors, ``cls``
    the rows' classes ``[B]`` at global indices ``idx`` ``[B]``.  Returns
    the new carry tuple."""
    level, above, below, detect = carry
    hit = cls == CLS_HIT
    clear = cls == CLS_CLEAR
    on = cls != CLS_PAD
    zero = torch.zeros_like(above)
    above = torch.where(hit, above + 1, torch.where(on, zero, above))
    below = torch.where(clear, below + 1, torch.where(on, zero, below))
    esc = hit & (above >= sustain_n) & (level < max_level)
    detect = torch.where(esc & (detect < 0), idx, detect)
    level = level + esc
    above = torch.where(esc, zero, above)
    deesc = clear & (below >= cool_n) & (level > 0)
    level = level - deesc.to(level.dtype)
    below = torch.where(deesc, zero, below)
    return level, above, below, detect


def escalation_step(carry, amp, idx, *, threshold, win: int, n,
                    sustain_n: int, cool_n: int, max_level: int = 3,
                    release=None):
    """One step of the escalation machine on an amplitude: classify
    ``amp`` at global index ``idx`` (``escalation_classify``), then one
    ``escalation_class_step``.  ``carry`` is the tuple ``(level, above,
    below, detect)`` of int64 tensors of one shape, ``amp`` and ``idx``
    broadcast against it.  Returns ``(carry', level)``."""
    cls = escalation_classify(amp, idx, threshold=threshold, win=win, n=n,
                              release=release)
    carry = escalation_class_step(carry, cls, idx, sustain_n=sustain_n,
                                  cool_n=cool_n, max_level=max_level)
    return carry, carry[0]


def escalation_fits_int32(carry: torch.Tensor, n: int, *, sustain_n: int,
                          cool_n: int, max_level: int) -> torch.Tensor:
    """Kernel D's range rule, per row of ``carry`` ``[B, 4]``: whether
    ``n`` steps from that carry keep ``level``, ``above`` and ``below`` in
    int32.  ``level`` stays within ``[min(level0, 0), max(level0,
    max_level)]``, and ``above`` and ``below`` grow by at most one a
    sample, so the rule is: ``level0``, ``max_level``, ``sustain_n`` and
    ``cool_n`` fit int32, and ``above0 + n`` and ``below0 + n`` stay below
    2^31 (with ``above0``, ``below0 >= -2^31``).  Rows where it fails run
    the kernel's int64 instantiation; the kernel checks the same rule."""
    lo, hi = -2 ** 31, 2 ** 31 - 1
    if not all(lo <= v <= hi for v in (sustain_n, cool_n, max_level)):
        return torch.zeros(carry.shape[0], dtype=torch.bool,
                           device=carry.device)
    level, above, below = carry[:, 0], carry[:, 1], carry[:, 2]
    return ((level >= lo) & (level <= hi) & (above >= lo) & (below >= lo)
            & (above <= hi - n) & (below <= hi - n))


def _idx0_rows(idx0: Union[int, torch.Tensor], rows: int, device
               ) -> torch.Tensor:
    idx0 = torch.as_tensor(idx0, dtype=torch.int64, device=device)
    return idx0.expand(rows).contiguous()


def escalation_scan_plain(cls: torch.Tensor, idx0, carry: torch.Tensor, *,
                          sustain_n: int, cool_n: int, max_level: int = 3
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's plain version: fold ``escalation_class_step`` over the
    samples of ``cls`` ``[B, n]`` in a Python loop.  Returns
    ``(carry' [B, 4], levels [B, n] int8)``."""
    B, n = cls.shape
    g0 = _idx0_rows(idx0, B, cls.device)
    levels = torch.empty((B, n), dtype=torch.int8, device=cls.device)
    state = carry.unbind(-1)
    for i in range(n):
        state = escalation_class_step(state, cls[:, i], g0 + i,
                                      sustain_n=sustain_n, cool_n=cool_n,
                                      max_level=max_level)
        levels[:, i] = state[0]
    return torch.stack(state, dim=-1), levels


def escalation_scan(cls: torch.Tensor, idx0, carry: torch.Tensor, *,
                    sustain_n: int, cool_n: int, max_level: int = 3
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The escalation machine over class streams ``cls`` ``[B, n]`` int8
    whose first samples sit at global index ``idx0`` (int or ``[B]``),
    from ``carry`` ``[B, 4]``.  Returns ``(carry', levels [B, n] int8)``.
    Chunked calls that pass the carry on equal one call."""
    if cls.dtype != torch.int8 or cls.dim() != 2:
        raise ValueError("cls must be an int8 [B, n] tensor")
    if carry.shape != (cls.shape[0], 4) or carry.dtype != torch.int64:
        raise ValueError("carry must be an int64 [B, 4] tensor")
    if cls.device.type == "cpu":
        return escalation_scan_plain(cls, idx0, carry, sustain_n=sustain_n,
                                     cool_n=cool_n, max_level=max_level)
    if cls.device.type != "cuda" or carry.device != cls.device:
        raise ValueError("escalation_scan: cls and carry must share one "
                         "CUDA device")
    B, n = cls.shape
    cls = cls.contiguous()
    carry = carry.contiguous()
    g0 = _idx0_rows(idx0, B, cls.device)
    levels = torch.empty((B, n), dtype=torch.int8, device=cls.device)
    carry_out = torch.empty_like(carry)
    ESCALATION_KERNEL.launch(
        ptr(cls), ptr(g0), ptr(carry), ptr(levels), ptr(carry_out), B, n,
        sustain_n, cool_n, max_level, stream_of(cls))
    return carry_out, levels


@dataclasses.dataclass(frozen=True)
class TelemetrySource:
    period_s: float = 0.001     # sampling period (1 ms fast counters)
    latency_s: float = 0.002    # read-out latency
    noise_w: float = 0.0
    quantization_w: float = 1.0
    averaged: bool = False      # True = boxcar average over period

    def measure(self, w: np.ndarray, dt: float, seed: int = 0) -> np.ndarray:
        """Sampled+delayed view of true power w (same length, ZOH)."""
        n = len(w)
        k = max(int(round(self.period_s / dt)), 1)
        lag = int(round(self.latency_s / dt))
        if self.averaged and k > 1:
            kernel = np.ones(k) / k
            base = np.convolve(w, kernel, mode="full")[:n]
        else:
            base = w
        idx = (np.arange(n) // k) * k          # zero-order hold at samples
        m = base[np.clip(idx - lag, 0, n - 1)]
        if self.noise_w > 0:
            rng = np.random.default_rng(seed)
            m = m + rng.normal(0.0, self.noise_w, size=n)
        if self.quantization_w > 0:
            m = np.round(m / self.quantization_w) * self.quantization_w
        return m

    def measure_batch(self, w: torch.Tensor, dt: float,
                      keys: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sampled, delayed, noisy and quantized view ``[B, n]`` of true
        power ``w`` ``[B, n]`` (float32), row ``b``'s noise drawn from
        ``keys[b]`` (``[B, 2]``; None: every row draws from
        ``prng_key(0)``, as the reference does without a key).

        The sampling indices are static.  ``averaged=True`` is a causal
        boxcar of ``k`` samples, summed in float64 as prefix sums and
        rounded once (the reference convolves in float32: ROADMAP queue
        C).  Rounding to ``quantization_w`` is half to even."""
        w = w.to(torch.float32)
        B, n = w.shape
        k = max(int(round(self.period_s / dt)), 1)
        lag = int(round(self.latency_s / dt))
        if self.averaged and k > 1:
            c = torch.cumsum(w.to(torch.float64), dim=-1)
            c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=-1)
            i = torch.arange(1, n + 1, device=w.device)
            kk = torch.tensor(float(k), dtype=torch.float64, device=w.device)
            base = ((c[:, 1:] - c[:, torch.clamp(i - k, min=0)]) / kk
                    ).to(torch.float32)
        else:
            base = w
        idx = np.clip((np.arange(n) // k) * k - lag, 0, n - 1)
        m = base[:, torch.as_tensor(idx, device=w.device)]
        if self.noise_w > 0:
            if keys is None:
                z = prng.normal(prng.prng_key(0, w.device), n)[None]
            else:
                z = prng.normal(keys.to(w.device), n)
            m = m + _f32(self.noise_w, w) * z
        if self.quantization_w > 0:
            q = _f32(self.quantization_w, w)
            m = torch.round(m / q) * q
        return m


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device: a 0-dim device tensor, so a
    division by it is a true division (a Python scalar divisor may run
    as a multiplication by its reciprocal on the card)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)
