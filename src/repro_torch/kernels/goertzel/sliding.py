"""Per-bin sliding amplitudes: kernel E of the port and its plain version.

``sliding_bin_power_v2`` computes what the reference's Pallas kernel
``sliding_goertzel_v2_pallas`` (``src/repro/kernels/goertzel/
goertzel.py``) computes, batched over rows: kernel A's per-bin sliding
amplitudes (``monitor.py`` gives the formula), warm-up scaled and
2/win-normalized, without the reduction to a worst bin.  For row ``r``,
segment ``s``, offset ``b`` and bin ``k``:

    2/win * |P_s[b] + e^{j w_k win} (P_{s-1}[win-1] - P_{s-1}[b])|
          * win / min(idx + 1, win),      idx = (seg0 + s) * win + b,

with ``P_{-1}`` the incoming state ``re0 + j im0``.  The outgoing state
is the prefix table of the call's last segment, so chunked calls that
pass it on (with ``seg0`` advanced) equal one call.

Operands: ``xseg`` ``[B, S, win]`` f32 (mean-removed), ``cosp``/``sinp``
``[K, win]`` f32, ``rot`` ``[K, 2]`` f32, ``seg0`` ``[B]`` int64,
``re0``/``im0`` ``[B, K, win]`` f32.  Outputs: ``amps``
``[B, S, win, K]`` f32, bins minor, so ``amps.reshape(B, S * win, K)``
is the ``[B, n, K]`` amplitude matrix without a copy; ``nre``/``nim``
``[B, K, win]`` f32.

On a CUDA tensor ``sliding_bin_power_v2`` launches the CUDA kernel
(``csrc/sliding.cu``); on a CPU tensor it runs
``sliding_bin_power_v2_plain``, which walks the segments in order with
``torch.cumsum``; any other device raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.telemetry import warmup_scale
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

SLIDING_KERNEL = CudaKernel(
    "goertzel/csrc/sliding.cu", "sliding_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(xseg, cosp, sinp, rot, seg0, re0, im0) -> None:
    B, S, win = xseg.shape
    K = cosp.shape[0]
    want = {"xseg": (xseg, (B, S, win), torch.float32),
            "cosp": (cosp, (K, win), torch.float32),
            "sinp": (sinp, (K, win), torch.float32),
            "rot": (rot, (K, 2), torch.float32),
            "seg0": (seg0, (B,), torch.int64),
            "re0": (re0, (B, K, win), torch.float32),
            "im0": (im0, (B, K, win), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"sliding_bin_power_v2: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != xseg.device:
            raise ValueError(f"sliding_bin_power_v2: {name} is on "
                             f"{t.device}, xseg on {xseg.device}")


def sliding_bin_power_v2_plain(xseg, cosp, sinp, rot, seg0, re0, im0
                               ) -> Outputs:
    """Kernel E's plain version: segment by segment, all rows and bins at
    once, carrying the previous segment's prefix table."""
    B, S, win = xseg.shape
    K = cosp.shape[0]
    rr = rot[:, 0][None, :, None]                  # [1, K, 1]
    ri = rot[:, 1][None, :, None]
    pos = torch.arange(win, device=xseg.device)
    amps = torch.empty((B, S, win, K), dtype=torch.float32,
                       device=xseg.device)
    prev_r, prev_i = re0, im0
    for s in range(S):
        x = xseg[:, s, None, :]                     # [B, 1, win]
        pr = torch.cumsum(x * cosp, dim=-1)         # [B, K, win]
        pi = torch.cumsum(x * (-sinp), dim=-1)
        dr = prev_r[..., -1:] - prev_r
        di = prev_i[..., -1:] - prev_i
        mr = pr + rr * dr - ri * di
        mi = pi + rr * di + ri * dr
        scale = warmup_scale((seg0[:, None] + s) * win + pos, win)
        amp = (2.0 / win) * torch.sqrt(mr * mr + mi * mi) * scale[:, None]
        amps[:, s] = amp.transpose(1, 2)
        prev_r, prev_i = pr, pi
    return amps, prev_r, prev_i


def sliding_bin_power_v2(xseg, cosp, sinp, rot, seg0, re0, im0) -> Outputs:
    """Per-bin sliding amplitudes over ``xseg`` ``[B, S, win]``; see the
    module docstring for operands and outputs."""
    _check(xseg, cosp, sinp, rot, seg0, re0, im0)
    if xseg.device.type == "cpu":
        return sliding_bin_power_v2_plain(xseg, cosp, sinp, rot, seg0, re0,
                                          im0)
    if xseg.device.type != "cuda":
        raise ValueError(f"sliding_bin_power_v2: no kernel for "
                         f"{xseg.device}")
    B, S, win = xseg.shape
    K = cosp.shape[0]
    args = [t.contiguous() for t in (xseg, cosp, sinp, rot, seg0, re0, im0)]
    amps = torch.empty((B, S, win, K), dtype=torch.float32,
                       device=xseg.device)
    nre = torch.empty_like(args[5])
    nim = torch.empty_like(args[6])
    SLIDING_KERNEL.launch(*(ptr(t) for t in args), ptr(amps), ptr(nre),
                          ptr(nim), B, S, win, K, stream_of(xseg))
    return amps, nre, nim
