"""The Goertzel monitors: trace -> per-bin amplitudes, over disjoint
windows or every sample's sliding window, or straight to the worst bin and
its escalation levels.

``bin_power`` gives per-window bin amplitudes ``[ceil(n/win), K]`` on
kernel H (``windows.goertzel_windows``); ``phase_tables_v1`` builds the
``[win, K]`` tables of kernel I (``sliding_v1.sliding_goertzel_v1``).

``sliding_bin_power`` emits every per-sample per-bin amplitude ``[n, K]``
on kernel E (``sliding.sliding_bin_power_v2``).  ``sliding_monitor_fused``
reduces them to the per-sample worst bin and its escalation class on
kernel A (``monitor.sliding_monitor``) and folds the escalation machine
over the class stream on kernel D (``core.telemetry.escalation_scan``);
the ``[n, K]`` matrix never exists.  ``monitor_worst_grad`` gives the
fused monitor's ``worst`` a gradient with respect to the trace: its
backward recomputes the per-bin amplitudes on kernel E and runs
``monitor.monitor_adjoint`` (the relaxed backstop's path).

Both run offline on whole traces or online on a chunked stream: pass
``carry=`` (from ``sliding_carry_init`` or ``monitor_carry_init``) and
each call consumes one chunk of a 1-D stream and returns the advanced
carry.  A partial segment is recomputed on its zero-padded window buffer
each call (a prefix at offset ``b`` depends on the samples up to ``b``
alone, in the kernels and the plain versions), and only the new rows are
emitted, so chunked calls of any sizes concatenate to one offline call
bit for bit.

Centring is in float64: the float32 mean of a 5e8 W trace is hundreds of
watts off, and that error reads as signal in every bin.  The offline path
subtracts the trace's float64 mean before the cast to float32; the carry
holds the mean as a Python float and subtracts it in float64 the same
way, so a carry built with ``mean=trace_mean(x)`` reproduces the offline
centring exactly.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.telemetry import (escalation_init, escalation_scan,
                                        warmup_scale)
from repro_torch.device import resolve_device
from repro_torch.kernels.goertzel.monitor import (monitor_adjoint,
                                                 sliding_monitor)
from repro_torch.kernels.goertzel.sliding import sliding_bin_power_v2
from repro_torch.kernels.goertzel.windows import goertzel_windows

#: ``n`` of an open-ended stream: no trailing pad to gate off
NO_PAD = torch.iinfo(torch.int64).max


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


@functools.lru_cache(maxsize=None)
def phase_tables_v1(freqs: Tuple[float, ...], dt: float, win: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``phase_tables`` in the v1 (bin-minor) layout of kernel I:
    ``cosp``/``sinp`` ``[win, K]`` and ``rot`` ``[2, K]``."""
    return tuple(np.ascontiguousarray(t.T)
                 for t in phase_tables(freqs, dt, win))


@functools.lru_cache(maxsize=None)
def device_tables(freqs: Tuple[float, ...], dt: float, win: int,
                  device: str) -> Tuple[torch.Tensor, ...]:
    """``phase_tables`` on ``device``, copied there once: the online path
    reads them every tick."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in phase_tables(freqs, dt, win))


def _tables(freqs, dt: float, win: int, device: torch.device):
    return device_tables(tuple(float(f) for f in freqs), float(dt), int(win),
                         str(device))


def trace_mean(x) -> float:
    """The float64 mean of a 1-D trace, taken as ``centre`` takes a row's:
    the ``mean`` of a carry whose chunked output must equal the offline
    call bit for bit."""
    x = torch.as_tensor(x)
    return float(x.to(torch.float64).reshape(1, -1).mean(-1)[0])


def centre(x: torch.Tensor) -> torch.Tensor:
    """``x`` ``[B, n]`` minus its row means, both in float64, as float32."""
    x64 = x.to(torch.float64)
    return (x64 - x64.mean(-1, keepdim=True)).to(torch.float32)


def segments(xc: torch.Tensor, win: int) -> torch.Tensor:
    """``[B, n]`` -> ``[B, S, win]``, the tail zero-padded."""
    B, n = xc.shape
    S = -(-n // win)
    return torch.nn.functional.pad(xc, (0, S * win - n)).reshape(B, S, win)


# ---------------------------------------------------------------------------
# per-window amplitudes (kernel H)
# ---------------------------------------------------------------------------

def goertzel_coef(freqs, dt: float) -> torch.Tensor:
    """``2 cos(2 pi f dt)`` per bin, float32 ``[K]``, in the float32 steps
    of the reference's compiled wrapper: XLA folds the two scalars first,
    ``(f32(2 pi) f32(dt)) f``, then takes the cosine of that float32 angle
    correctly rounded.  A coefficient one ulp off moves a low bin's
    frequency by ulp / (2 sin w)."""
    f = np.asarray(freqs, np.float32)
    omega = (np.float32(2.0 * np.pi) * np.float32(dt)) * f
    return torch.from_numpy(
        (2.0 * np.cos(omega.astype(np.float64))).astype(np.float32))


def bin_power(x, dt: float, freqs: Sequence[float], *, win: int,
              block_w: int = 8, device=None) -> torch.Tensor:
    """``x`` ``[n]`` power samples -> ``[ceil(n/win), K]`` bin amplitudes
    over non-overlapping windows, on kernel H, on ``device`` (``None``:
    the card; ``"cpu"`` runs the plain version).

    The reference's contract: each window loses its own mean, taken over
    its true sample count; the trailing partial window (``n % win``
    samples, or all of a trace shorter than ``win``) is zero-padded after
    that, its pad samples stay exactly 0, and its amplitudes are rescaled
    by ``win / count``.  ``W`` is padded to a multiple of ``block_w`` for
    the kernel and trimmed after.  The means and the subtraction are in
    float64, rounded once to float32 (ROADMAP queue C).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev).reshape(-1)
    n = x.shape[0]
    W = -(-n // win)
    pad_n = W * win - n
    counts = torch.full((W,), float(win), dtype=torch.float32, device=dev)
    if pad_n:
        counts[-1] = float(win - pad_n)
    x64 = torch.nn.functional.pad(x.to(torch.float64), (0, pad_n))
    windows = x64.reshape(W, win)
    valid = (torch.arange(win, device=dev)[None, :]
             < counts.to(torch.int64)[:, None])
    means = (torch.where(valid, windows, 0.0).sum(1, keepdim=True)
             / counts[:, None].to(torch.float64))
    windows = torch.where(valid, windows - means, 0.0).to(torch.float32)
    windows = torch.nn.functional.pad(windows, (0, 0, 0, (-W) % block_w))
    out = goertzel_windows(windows, goertzel_coef(freqs, dt).to(dev),
                           block_w=block_w)
    # the kernel normalizes by 2/win; partial windows rescale to 2/count
    # (a true division: ``float / tensor`` would multiply by a reciprocal)
    scale = torch.div(torch.tensor(float(win), device=dev), counts)
    return out[:W] * scale[:, None]


# ---------------------------------------------------------------------------
# per-bin amplitudes (kernel E)
# ---------------------------------------------------------------------------

class SlidingCarry(NamedTuple):
    """Cross-chunk state of the sliding monitor.

    ``seg`` ``[1, win]`` is the current (centred, zero-padded) segment
    with ``fill`` valid samples; ``prev_re``/``prev_im`` ``[1, K, win]``
    are the previous segment's prefix tables, the state the kernels
    stream in and out.  ``offset`` is the global index of the next
    sample; ``mean`` the DC level subtracted from every sample, in
    float64.  Build with ``sliding_carry_init``; treat as opaque."""
    offset: int
    fill: int
    seg: torch.Tensor
    prev_re: torch.Tensor
    prev_im: torch.Tensor
    mean: float


def sliding_carry_init(dt: float, freqs, *, win: int, mean: float = 0.0,
                       device=None) -> SlidingCarry:
    """Fresh state for chunked calls on ``device`` (``None``: the card;
    ``"cpu"`` runs the plain versions).  For bit parity with the offline
    call on a known trace pass ``mean=trace_mean(x)``; for a live stream,
    the fleet's operating point."""
    del dt
    device = resolve_device(device)
    zeros = torch.zeros((1, len(tuple(freqs)), win), dtype=torch.float32,
                        device=device)
    return SlidingCarry(offset=0, fill=0,
                        seg=torch.zeros((1, win), dtype=torch.float32,
                                        device=device),
                        prev_re=zeros, prev_im=zeros, mean=float(mean))


def _centre_chunk(x, mean: float, device) -> torch.Tensor:
    """A chunk minus the carried float64 mean, as float32 (``centre``'s
    arithmetic with the mean given).  A tensor chunk must already lie on
    the carry's device; host (numpy) data is copied there."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"chunk on {x.device} but the carry is on {device}:"
                         " move one of them")
    x = torch.as_tensor(x, device=device).reshape(-1)
    return (x.to(torch.float64) - mean).to(torch.float32)


def _segment_walk(xc: torch.Tensor, carry: SlidingCarry, win: int):
    """Cut the centred chunk ``xc`` into the pieces of the segments it
    touches.  Returns ``(pieces, (offset, fill, seg))``: per piece the
    zero-padded segment ``[1, 1, win]``, its global index ``seg0`` and the
    valid range ``[fill, new_fill)`` it adds; then the carry's segment
    state after the chunk."""
    offset, fill, seg = carry.offset, carry.fill, carry.seg
    pieces = []
    pos, m = 0, xc.shape[0]
    while pos < m:
        take = min(win - fill, m - pos)
        seg = seg.clone()
        seg[0, fill:fill + take] = xc[pos:pos + take]
        new_fill = fill + take
        pieces.append((seg[:, None, :], (offset - fill) // win, fill,
                       new_fill))
        if new_fill == win:
            seg = torch.zeros_like(seg)
            fill = 0
        else:
            fill = new_fill
        offset += take
        pos += take
    return pieces, (offset, fill, seg)


def _seg0(v: int, device) -> torch.Tensor:
    return torch.tensor([v], dtype=torch.int64, device=device)


def _sliding_bin_power_carry(x, dt: float, freqs, *, win: int,
                             carry: SlidingCarry):
    dev = carry.seg.device
    cosp, sinp, rot = _tables(freqs, dt, win, dev)
    K = cosp.shape[0]
    xc = _centre_chunk(x, carry.mean, dev)
    prev_re, prev_im = carry.prev_re, carry.prev_im
    outs = []
    pieces, (offset, fill, seg) = _segment_walk(xc, carry, win)
    for piece, seg0, lo, hi in pieces:
        amps, nre, nim = sliding_bin_power_v2(piece, cosp, sinp, rot,
                                              _seg0(seg0, dev), prev_re,
                                              prev_im)
        outs.append(amps[0, 0, lo:hi])
        if hi == win:
            prev_re, prev_im = nre, nim
    amps = (torch.cat(outs) if outs
            else torch.zeros((0, K), dtype=torch.float32, device=dev))
    return amps, SlidingCarry(offset=offset, fill=fill, seg=seg,
                              prev_re=prev_re, prev_im=prev_im,
                              mean=carry.mean)


def sliding_bin_power(x, dt: float, freqs: Sequence[float], *, win: int,
                      carry: Optional[SlidingCarry] = None):
    """Every-sample sliding-window bin amplitudes on kernel E.

    Offline: ``x`` ``[n]`` -> ``[n, K]`` on ``x``'s device, centred on its
    float64 mean; the first ``win - 1`` outputs are partial-window
    estimates normalized by their true sample count.  Semantics of the
    float64 oracle ``ref.sliding_bin_power_ref``.

    With ``carry=``, ``x`` is one chunk ``[m]`` of a stream: returns
    ``(amps [m, K], carry')`` on the carry's device, and chunked calls
    concatenate to the offline call bit for bit (given
    ``mean=trace_mean(full)``).
    """
    if carry is not None:
        return _sliding_bin_power_carry(x, dt, freqs, win=win, carry=carry)
    x = torch.as_tensor(x).reshape(1, -1)
    n, dev = x.shape[1], x.device
    cosp, sinp, rot = _tables(freqs, dt, win, dev)
    K = cosp.shape[0]
    zeros = torch.zeros((1, K, win), dtype=torch.float32, device=dev)
    amps, _, _ = sliding_bin_power_v2(
        segments(centre(x), win), cosp, sinp, rot,
        torch.zeros(1, dtype=torch.int64, device=dev), zeros, zeros)
    return amps.reshape(-1, K)[:n]                       # a view


# ---------------------------------------------------------------------------
# the fused monitor (kernels A and D)
# ---------------------------------------------------------------------------

class MonitorCarry(NamedTuple):
    """Cross-chunk state of the fused monitor: the sliding carry and the
    escalation machine's ``[1, 4]`` int64 ``(level, above, below,
    detect)``.  Build with ``monitor_carry_init``."""
    sliding: SlidingCarry
    esc: torch.Tensor


def monitor_carry_init(dt: float, freqs, *, win: int, mean: float = 0.0,
                       device=None) -> MonitorCarry:
    """Fresh fused-monitor state (see ``sliding_carry_init``)."""
    device = resolve_device(device)
    return MonitorCarry(
        sliding=sliding_carry_init(dt, freqs, win=win, mean=mean,
                                   device=device),
        esc=escalation_init(1, device))


def _rows(v, B: int, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=dev).expand(B).contiguous()


def amps_at(nre, nim, prev_re, prev_im, rot, b: int, idx: int, win: int
            ) -> torch.Tensor:
    """Per-bin amplitudes ``[K]`` at in-segment offset ``b`` (global index
    ``idx``), recombined from the current segment's prefix tables
    ``nre``/``nim`` and the previous segment's ``[1, K, win]``: the O(K)
    way the fused online path reports per-bin amplitudes."""
    dr = prev_re[0, :, win - 1] - prev_re[0, :, b]
    di = prev_im[0, :, win - 1] - prev_im[0, :, b]
    rr, ri = rot[:, 0], rot[:, 1]
    mr = nre[0, :, b] + rr * dr - ri * di
    mi = nim[0, :, b] + rr * di + ri * dr
    idx_t = torch.tensor(idx, dtype=torch.int64, device=nre.device)
    return (2.0 / win) * torch.sqrt(mr * mr + mi * mi) * warmup_scale(
        idx_t, win)


def _sliding_monitor_carry(x, thr, rel, dt: float, freqs, *, win: int,
                           sustain_n: int, cool_n: int, max_level: int,
                           carry: MonitorCarry):
    sl = carry.sliding
    dev = sl.seg.device
    cosp, sinp, rot = _tables(freqs, dt, win, dev)
    K = cosp.shape[0]
    xc = _centre_chunk(x, sl.mean, dev)
    thr_t = _rows(thr, 1, torch.float32, dev)
    rel_t = _rows(rel, 1, torch.float32, dev)
    n_t = _rows(NO_PAD, 1, torch.int64, dev)
    prev_re, prev_im = sl.prev_re, sl.prev_im
    worsts, clss = [], []
    last = None
    pieces, (offset, fill, seg) = _segment_walk(xc, sl, win)
    for piece, seg0, lo, hi in pieces:
        worst, cls, _, nre, nim = sliding_monitor(
            piece, cosp, sinp, rot, thr_t, rel_t, n_t, _seg0(seg0, dev),
            prev_re, prev_im)
        worsts.append(worst[0, 0, lo:hi])
        clss.append(cls[0, 0, lo:hi])
        # the chunk's last sample: its segment's prefix tables, the
        # previous segment's, its in-segment offset and global index
        last = (nre, nim, prev_re, prev_im, hi - 1, seg0 * win + hi - 1)
        if hi == win:
            prev_re, prev_im = nre, nim
    if worsts:
        esc, levels = escalation_scan(
            torch.cat(clss)[None], sl.offset, carry.esc,
            sustain_n=sustain_n, cool_n=cool_n, max_level=max_level)
        nre, nim, pre, pim, b, idx = last
        amps_last = amps_at(nre, nim, pre, pim, rot, b, idx, win)
        worst_cat, levels = torch.cat(worsts), levels[0]
    else:
        esc = carry.esc
        worst_cat = torch.zeros(0, dtype=torch.float32, device=dev)
        levels = torch.zeros(0, dtype=torch.int8, device=dev)
        amps_last = torch.zeros(K, dtype=torch.float32, device=dev)
    new = MonitorCarry(
        sliding=SlidingCarry(offset=offset, fill=fill, seg=seg,
                             prev_re=prev_re, prev_im=prev_im, mean=sl.mean),
        esc=esc)
    return worst_cat, levels, amps_last, new


def sliding_monitor_fused(x: torch.Tensor, dt: float, freqs: Sequence[float],
                          *, win: int, threshold, sustain_n: int,
                          cool_n: int, max_level: int = 3, release=None,
                          carry: Optional[MonitorCarry] = None):
    """The fused sliding monitor.

    Offline, over the rows of ``x`` ``[B, n]``: ``threshold`` (and
    ``release``, default ``threshold``) is a float or a per-row ``[B]``
    tensor.  Returns ``(worst [B, n] f32, levels [B, n] int8, detect [B]
    int64, peaks [B, S, K] f32)``: the per-sample worst-bin amplitude, the
    escalation level (sustain/cool hysteresis, warm-up and pad gated), the
    first escalation's sample index (-1 if none) and the per-segment
    per-bin peak amplitudes over live samples.

    Online (``carry=`` a ``MonitorCarry``): ``x`` is one chunk ``[m]`` of
    a stream.  Returns ``(worst [m], levels [m], amps_last [K], carry')``
    on the carry's device; chunked ``worst``/``levels`` equal the offline
    call's bit for bit (given ``mean=trace_mean(full)``), and
    ``amps_last`` are the per-bin amplitudes at the chunk's last sample.
    """
    rel = threshold if release is None else release
    if carry is not None:
        return _sliding_monitor_carry(
            x, threshold, rel, dt, freqs, win=win, sustain_n=sustain_n,
            cool_n=cool_n, max_level=max_level, carry=carry)
    B, n = x.shape
    dev = x.device
    cosp, sinp, rot = _tables(freqs, dt, win, dev)
    thr = _rows(threshold, B, torch.float32, dev)
    rel = _rows(rel, B, torch.float32, dev)
    zeros = torch.zeros((B, len(freqs), win), dtype=torch.float32,
                        device=dev)
    xseg = segments(centre(x), win)
    worst, cls, peaks, _, _ = sliding_monitor(
        xseg, cosp, sinp, rot, thr, rel, _rows(n, B, torch.int64, dev),
        torch.zeros(B, dtype=torch.int64, device=dev), zeros, zeros)
    carry, levels = escalation_scan(
        cls.reshape(B, -1)[:, :n].contiguous(), 0,
        escalation_init(B, dev), sustain_n=sustain_n, cool_n=cool_n,
        max_level=max_level)
    return worst.reshape(B, -1)[:, :n], levels, carry[:, 3], peaks


class _MonitorWorst(torch.autograd.Function):
    """The fused monitor's ``worst`` as a function of the trace ``w``: the
    forward hands back the values kernel A computed; the backward
    recomputes every bin's amplitude on kernel E (equal to A's bit for bit,
    so its maximum marks A's worst bin) and runs the adjoint on them."""

    @staticmethod
    def forward(ctx, w, worst, dt, freqs, win):
        ctx.save_for_backward(w)
        ctx.dt, ctx.freqs, ctx.win = dt, freqs, win
        return worst.clone()

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        B, n = w.shape
        dev = w.device
        cosp, sinp, rot = _tables(ctx.freqs, ctx.dt, ctx.win, dev)
        K = cosp.shape[0]
        xc = centre(w.detach().to(torch.float32))
        zeros = torch.zeros((B, K, ctx.win), dtype=torch.float32, device=dev)
        amps, _, _ = sliding_bin_power_v2(
            segments(xc, ctx.win), cosp, sinp, rot,
            torch.zeros(B, dtype=torch.int64, device=dev), zeros, zeros)
        amps = amps.reshape(B, -1, K)[:, :n]
        dw = monitor_adjoint(xc, amps, g.to(torch.float32), ctx.freqs,
                             ctx.dt, ctx.win)
        return dw.to(w.dtype), None, None, None, None


def monitor_worst_grad(w: torch.Tensor, worst: torch.Tensor, dt: float,
                       freqs: Sequence[float], *, win: int) -> torch.Tensor:
    """``worst`` ``[B, n]`` from ``sliding_monitor_fused(w.detach(), ...)``
    with a gradient with respect to ``w`` ``[B, n]``: that of the
    reference's ``max`` over the jnp monitor's bins (the centring, the
    windowed DFT, ``|.|`` and the max, a tie split equally)."""
    return _MonitorWorst.apply(w, worst, float(dt),
                               tuple(float(f) for f in freqs), int(win))
