"""The fused sliding monitor: kernel A of the port and its plain version.

``sliding_monitor`` computes what the reference's Pallas kernel
``sliding_monitor_pallas`` (``src/repro/kernels/goertzel/goertzel.py``)
computes, batched over rows: per-bin sliding-window DFT amplitudes from
per-segment modulated prefix sums, reduced to the per-sample worst bin,
its escalation class and the per-segment per-bin peaks over live samples,
with the prefix state streamed in and out.

For segment ``s`` of a row (``win`` samples ``x_s``) and bin ``k``, with
``P_s[b] = sum_{p <= b} x_s[p] e^{-j w_k p}``, the window that ends at
offset ``b`` has amplitude

    2/win * |P_s[b] + e^{j w_k win} (P_{s-1}[win-1] - P_{s-1}[b])|
          * win / min(idx + 1, win),      idx = (seg0 + s) * win + b,

where ``P_{-1}`` is the incoming state ``re0 + j im0``.  A sample is live
when ``win - 1 <= idx < n``; its class is 2 above the threshold, 0 at or
below the release (or not live), 1 in between.  The outgoing state is the
prefix table of the call's last segment, so chunked calls that pass it on
(with ``seg0`` advanced) equal one call.

Operands (``B`` rows, ``S`` segments, ``K`` bins): ``xseg`` ``[B, S, win]``
f32 (mean-removed), ``cosp``/``sinp`` ``[K, win]`` f32 phase tables (host
float64, cast), ``rot`` ``[K, 2]`` = [cos, sin](w_k win), ``thr``/``rel``
``[B]`` f32, ``n``/``seg0`` ``[B]`` int64, ``re0``/``im0`` ``[B, K, win]``.
Outputs: ``worst`` ``[B, S, win]`` f32, ``cls`` ``[B, S, win]`` int8,
``peaks`` ``[B, S, K]`` f32, ``nre``/``nim`` ``[B, K, win]`` f32.

On a CUDA tensor ``sliding_monitor`` launches the CUDA kernel
(``csrc/monitor.cu``: one thread-block cluster per (row, segment), one
block per bin, the segment staged in shared memory, the worst over bins
reduced through the cluster's shared memory); on a CPU tensor it runs
``sliding_monitor_plain``, which walks the segments in order with
``torch.cumsum``.

``monitor_adjoint`` is the worst-bin amplitude's adjoint, which the
relaxed backstop's gradient runs through (``ops.monitor_worst_grad``): on
a CUDA tensor the CUDA kernel ``csrc/monitor_adjoint.cu``, on a CPU tensor
``monitor_adjoint_plain``, its float64 formula in torch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.telemetry import escalation_classify, warmup_scale
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

MONITOR_KERNEL = CudaKernel(
    "goertzel/csrc/monitor.cu", "monitor_launch",
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

MONITOR_ADJOINT_KERNEL = CudaKernel(
    "goertzel/csrc/monitor_adjoint.cu", "monitor_adjoint_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p])

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def _check(xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0) -> None:
    B, S, win = xseg.shape
    K = cosp.shape[0]
    want = {"xseg": (xseg, (B, S, win), torch.float32),
            "cosp": (cosp, (K, win), torch.float32),
            "sinp": (sinp, (K, win), torch.float32),
            "rot": (rot, (K, 2), torch.float32),
            "thr": (thr, (B,), torch.float32),
            "rel": (rel, (B,), torch.float32),
            "n": (n, (B,), torch.int64),
            "seg0": (seg0, (B,), torch.int64),
            "re0": (re0, (B, K, win), torch.float32),
            "im0": (im0, (B, K, win), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"sliding_monitor: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != xseg.device:
            raise ValueError(f"sliding_monitor: {name} is on {t.device}, "
                             f"xseg on {xseg.device}")


def sliding_monitor_plain(xseg, cosp, sinp, rot, thr, rel, n, seg0, re0,
                          im0) -> Outputs:
    """Kernel A's plain version: segment by segment, all rows and bins at
    once, carrying the previous segment's prefix table."""
    B, S, win = xseg.shape
    K = cosp.shape[0]
    rr = rot[:, 0][None, :, None]                  # [1, K, 1]
    ri = rot[:, 1][None, :, None]
    pos = torch.arange(win, device=xseg.device)
    worst = torch.empty_like(xseg)
    cls = torch.empty(xseg.shape, dtype=torch.int8, device=xseg.device)
    peaks = torch.empty((B, S, K), dtype=torch.float32, device=xseg.device)
    prev_r, prev_i = re0, im0
    for s in range(S):
        x = xseg[:, s, None, :]                     # [B, 1, win]
        pr = torch.cumsum(x * cosp, dim=-1)         # [B, K, win]
        pi = torch.cumsum(x * (-sinp), dim=-1)
        dr = prev_r[..., -1:] - prev_r
        di = prev_i[..., -1:] - prev_i
        mr = pr + rr * dr - ri * di
        mi = pi + rr * di + ri * dr
        idx = (seg0[:, None] + s) * win + pos       # [B, win] int64
        scale = warmup_scale(idx, win)
        amp = (2.0 / win) * torch.sqrt(mr * mr + mi * mi) * scale[:, None]
        live = (idx >= win - 1) & (idx < n[:, None])
        peaks[:, s] = torch.where(live[:, None], amp, 0.0).amax(-1)
        worst[:, s] = amp.amax(1)
        cls[:, s] = escalation_classify(worst[:, s], idx, threshold=thr[:, None],
                                        win=win, n=n[:, None],
                                        release=rel[:, None])
        prev_r, prev_i = pr, pi
    return worst, cls, peaks, prev_r, prev_i


def sliding_monitor(xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0
                    ) -> Outputs:
    """The fused monitor over ``xseg`` ``[B, S, win]``; see the module
    docstring for operands and outputs."""
    _check(xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0)
    if xseg.device.type == "cpu":
        return sliding_monitor_plain(xseg, cosp, sinp, rot, thr, rel, n,
                                     seg0, re0, im0)
    if xseg.device.type != "cuda":
        raise ValueError(f"sliding_monitor: no kernel for {xseg.device}")
    B, S, win = xseg.shape
    K = cosp.shape[0]
    args = [t.contiguous() for t in
            (xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0)]
    worst = torch.empty_like(args[0])
    cls = torch.empty(xseg.shape, dtype=torch.int8, device=xseg.device)
    peaks = torch.empty((B, S, K), dtype=torch.float32, device=xseg.device)
    nre = torch.empty_like(args[8])
    nim = torch.empty_like(args[9])
    MONITOR_KERNEL.launch(*(ptr(t) for t in args), ptr(worst), ptr(cls),
                          ptr(peaks), ptr(nre), ptr(nim), B, S, win, K,
                          stream_of(xseg))
    return worst, cls, peaks, nre, nim


def phase_steps(freqs, dt: float) -> np.ndarray:
    """``2 f_k dt`` per bin in float64: bin ``k``'s phase at sample ``j`` is
    ``pi`` times it times ``j``."""
    return 2.0 * np.asarray(freqs, np.float64) * float(dt)


def monitor_adjoint_plain(xc, amps, g, freqs, dt: float, win: int
                          ) -> torch.Tensor:
    """The adjoint of the worst-bin amplitude in float64, straight from its
    formula (``csrc/monitor_adjoint.cu``'s header): ``d L / d x`` ``[B, n]``
    of the raw trace (through its centring) from ``g`` = ``d L / d worst``
    ``[B, n]``, the centred trace ``xc`` ``[B, n]`` and the per-bin
    amplitudes ``amps`` ``[B, n, K]`` whose maximum is the worst bin (a tie
    splits the gradient equally; a bin with ``|S| = 0`` gets none, and no
    bin of a sample whose worst amplitude is 2^-24 of the row's amplitude
    scale ``max |xc|`` or less, the forward's rounding noise, does)."""
    B, n = xc.shape
    dev = xc.device
    j = torch.arange(n, dtype=torch.float64, device=dev)
    step = torch.as_tensor(phase_steps(freqs, dt), device=dev)
    ph = torch.exp(-1j * torch.pi * step[:, None] * j[None, :])   # [K, n]
    P = torch.cumsum(xc.to(torch.float64)[:, None, :] * ph, dim=-1)
    S = P.clone()
    S[..., win:] -= P[..., :-win]
    top = amps.amax(-1, keepdim=True)
    # where the worst amplitude is at the forward's f32 rounding noise (2^-24
    # of the row's amplitude scale or less), no bin gets any: S there is
    # noise, and so is its direction
    noise = xc.abs().amax(-1, keepdim=True)[..., None] * 2.0 ** -24
    mask = ((amps == top) & (top > noise)).to(torch.float64)
    share = (mask / mask.sum(-1, keepdim=True).clamp(min=1.0)).transpose(
        1, 2)                                                    # [B, K, n]
    m = S.abs()
    denom = torch.clamp(j + 1.0, max=float(win))
    coef = torch.where(m > 0, g.to(torch.float64)[:, None, :] * share * 2.0
                       / denom / torch.where(m > 0, m, 1.0), 0.0)
    z = coef * S.conj()
    R = torch.flip(torch.cumsum(torch.flip(z, [-1]), -1), [-1])
    Z = R.clone()
    Z[..., :-win] -= R[..., win:]
    y = (ph * Z).real.sum(1)
    return (y - y.mean(-1, keepdim=True)).to(torch.float32)


def monitor_adjoint(xc, amps, g, freqs, dt: float, win: int
                    ) -> torch.Tensor:
    """``monitor_adjoint_plain``'s result on the card's kernel for CUDA
    tensors (``xc``, ``g`` ``[B, n]`` and ``amps`` ``[B, n, K]``, all f32),
    the plain version for CPU tensors."""
    B, n = xc.shape
    K = len(tuple(freqs))
    for name, t, shape in (("xc", xc, (B, n)), ("g", g, (B, n)),
                           ("amps", amps, (B, n, K))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"monitor_adjoint: {name} must be f32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != xc.device:
            raise ValueError(f"monitor_adjoint: {name} is on {t.device}, xc "
                             f"on {xc.device}")
    if xc.device.type == "cpu":
        return monitor_adjoint_plain(xc, amps, g, freqs, dt, win)
    if xc.device.type != "cuda":
        raise ValueError(f"monitor_adjoint: no kernel for {xc.device}")
    xc, amps, g = (t.contiguous() for t in (xc, amps, g))
    step = torch.as_tensor(phase_steps(freqs, dt), device=xc.device)
    P = torch.empty((B, K, n, 2), dtype=torch.float64, device=xc.device)
    R = torch.empty_like(P)
    done = torch.empty(B, dtype=torch.int32, device=xc.device)
    dw = torch.empty_like(xc)
    MONITOR_ADJOINT_KERNEL.launch(ptr(xc), ptr(amps), ptr(g), ptr(step),
                                  ptr(P), ptr(R), ptr(done), ptr(dw), B, n,
                                  K, int(win), stream_of(xc))
    return dw
