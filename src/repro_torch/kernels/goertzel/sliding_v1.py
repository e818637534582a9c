"""Per-bin sliding amplitudes in the v1 (bin-minor) layout: kernel I of the
port and its plain version.

``sliding_goertzel_v1`` computes what the reference's Pallas kernel
``sliding_goertzel_pallas`` (``src/repro/kernels/goertzel/goertzel.py``)
computes: kernel E's amplitudes (``sliding.py`` gives the formula) with
the phase tables in the ``[win, K]`` layout, one row of segments, the
prefix state starting at zero, and no warm-up scale (the caller applies
it, as the reference's benchmark wrapper does).

Operands: ``xseg`` ``[S, win]`` f32 (the centred, zero-padded trace),
``cosp``/``sinp`` ``[win, K]`` f32 and ``rot`` ``[2, K]`` f32
(``ops.phase_tables_v1``).  Output ``[S, win, K]`` f32.  ``S`` must
divide into blocks of ``block_s`` segments, as the reference asserts;
the kernel does not use ``block_s`` beyond that check.

On a CUDA tensor it launches the CUDA kernel (``csrc/sliding_v1.cu``:
kernel E's body, ``csrc/sliding_walk.cuh``, in its mode with no scale and
no state, on the geometry ``sliding.launch_geometry`` chooses), one
launch and no scratch buffer; on a CPU tensor it runs
``sliding_goertzel_v1_plain``, which walks the segments in order with
``torch.cumsum``; any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, ptr, stream_of
from repro_torch.kernels.goertzel.sliding import launch_geometry

SLIDING_V1_KERNEL = CudaKernel(
    "goertzel/csrc/sliding_v1.cu", "sliding_v1_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _check(xseg, cosp, sinp, rot, block_s: int) -> None:
    if xseg.dim() != 2 or cosp.dim() != 2:
        raise ValueError(f"sliding_goertzel_v1: xseg must be [S, win] and "
                         f"cosp [win, K]; got {tuple(xseg.shape)}, "
                         f"{tuple(cosp.shape)}")
    S, win = xseg.shape
    K = cosp.shape[1]
    want = {"xseg": (xseg, (S, win)), "cosp": (cosp, (win, K)),
            "sinp": (sinp, (win, K)), "rot": (rot, (2, K))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"sliding_goertzel_v1: {name} must be float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != xseg.device:
            raise ValueError(f"sliding_goertzel_v1: {name} is on "
                             f"{t.device}, xseg on {xseg.device}")
    if block_s < 1 or S % block_s:
        raise ValueError(f"sliding_goertzel_v1: S={S} must divide into "
                         f"blocks of block_s={block_s}")


def sliding_goertzel_v1_plain(xseg, cosp, sinp, rot, *, block_s: int = 1):
    """Kernel I's plain version: segment by segment, all bins at once,
    carrying the previous segment's prefix table."""
    del block_s
    S, win = xseg.shape
    K = cosp.shape[1]
    rr, ri = rot[0], rot[1]                          # [K]
    out = torch.empty((S, win, K), dtype=torch.float32, device=xseg.device)
    prev_r = torch.zeros((win, K), dtype=torch.float32, device=xseg.device)
    prev_i = torch.zeros_like(prev_r)
    for s in range(S):
        x = xseg[s, :, None]                         # [win, 1]
        pr = torch.cumsum(x * cosp, dim=0)           # [win, K]
        pi = torch.cumsum(x * (-sinp), dim=0)
        dr = prev_r[-1:] - prev_r
        di = prev_i[-1:] - prev_i
        mr = pr + rr * dr - ri * di
        mi = pi + rr * di + ri * dr
        out[s] = (2.0 / win) * torch.sqrt(mr * mr + mi * mi)
        prev_r, prev_i = pr, pi
    return out


def sliding_goertzel_v1(xseg, cosp, sinp, rot, *, block_s: int = 1):
    """Sliding amplitudes ``[S, win, K]`` over ``xseg``; see the module
    docstring."""
    _check(xseg, cosp, sinp, rot, block_s)
    if xseg.device.type == "cpu":
        return sliding_goertzel_v1_plain(xseg, cosp, sinp, rot,
                                         block_s=block_s)
    if xseg.device.type != "cuda":
        raise ValueError(f"sliding_goertzel_v1: no kernel for {xseg.device}")
    S, win = xseg.shape
    K = cosp.shape[1]
    args = [t.contiguous() for t in (xseg, cosp, sinp, rot)]
    out = torch.empty((S, win, K), dtype=torch.float32, device=xseg.device)
    route, group = launch_geometry(SLIDING_V1_KERNEL,
                                   "sliding_v1_active_clusters", 1, S, win, K)
    SLIDING_V1_KERNEL.launch(*(ptr(t) for t in args), ptr(out), S, win, K,
                             int(route.resident), route.J, group,
                             stream_of(xseg))
    return out
