"""Goertzel resonators on disjoint windows: kernel H of the port and its
plain version.

``goertzel_windows`` computes what the reference's Pallas kernel
``goertzel_pallas`` (``src/repro/kernels/goertzel/goertzel.py``)
computes: for each window ``w`` of ``windows`` ``[W, win]`` f32 and each
coefficient ``coef[k] = 2 cos(2 pi f_k dt)`` of ``coef`` ``[K]`` f32,
the recurrence

    s0 = x[t] + coef_k s1 - s2,     t = 0 .. win-1, from s1 = s2 = 0,

and the amplitude ``2/win sqrt(max(s1 s1 + s2 s2 - coef_k s1 s2, 0))``,
into ``[W, K]`` f32, in the rounding order the reference runs in as XLA
compiles it: ``s0 = fma(coef_k, s1, x) - s2`` and ``power =
fma(-(coef_k s1), s2, fma(s1, s1, s2 s2))`` (JAX's ``goertzel_pallas``
in interpret mode and its ``goertzel_ref`` equal this bit for bit on the
CPU).  ``W`` must divide into blocks of ``block_w``
windows, as the reference asserts; ``ops.bin_power`` pads it.

On a CUDA tensor it launches the CUDA kernel (``csrc/windows.cu``); on a
CPU tensor it runs ``goertzel_windows_plain``, the same recurrence in the
same order, all windows and bins at once; any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, ptr, stream_of

WINDOWS_KERNEL = CudaKernel(
    "goertzel/csrc/windows.cu", "windows_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

#: the most threads (windows x bins) one block of the kernel takes
MAX_BLOCK_THREADS = 1024


def _check(windows, coef, block_w: int) -> None:
    if windows.dim() != 2 or coef.dim() != 1:
        raise ValueError(f"goertzel_windows: windows must be [W, win] and "
                         f"coef [K]; got {tuple(windows.shape)}, "
                         f"{tuple(coef.shape)}")
    for name, t in (("windows", windows), ("coef", coef)):
        if t.dtype != torch.float32:
            raise ValueError(f"goertzel_windows: {name} must be float32, "
                             f"got {t.dtype}")
    if coef.device != windows.device:
        raise ValueError(f"goertzel_windows: coef on {coef.device}, "
                         f"windows on {windows.device}")
    if block_w < 1 or windows.shape[0] % block_w:
        raise ValueError(f"goertzel_windows: W={windows.shape[0]} must "
                         f"divide into blocks of block_w={block_w}")


def fma32(a, b, c):
    """``a b + c`` for float32 tensors with one rounding, through float64
    (the product of two float32 values is exact there; the float64 sum's
    own rounding can change the float32 result only in a tie, about once
    in 2^29 operations)."""
    return (a.double() * b.double() + c.double()).float()


def goertzel_windows_plain(windows, coef, *, block_w: int = 8):
    """Kernel H's plain version: the recurrence over the samples in order,
    in the kernel's rounding order."""
    del block_w
    W, win = windows.shape
    s1 = torch.zeros((W, coef.shape[0]), dtype=torch.float32,
                     device=windows.device)
    s2 = torch.zeros_like(s1)
    c = coef[None, :].expand_as(s1)
    for t in range(win):
        s1, s2 = fma32(c, s1, windows[:, t, None].expand_as(s1)) - s2, s1
    power = fma32(-(c * s1), s2, fma32(s1, s1, s2 * s2))
    return (2.0 / win) * torch.sqrt(torch.clamp_min(power, 0.0))


def goertzel_windows(windows, coef, *, block_w: int = 8):
    """Amplitudes ``[W, K]`` of ``coef``'s resonators over each window;
    see the module docstring."""
    _check(windows, coef, block_w)
    if windows.device.type == "cpu":
        return goertzel_windows_plain(windows, coef, block_w=block_w)
    if windows.device.type != "cuda":
        raise ValueError(f"goertzel_windows: no kernel for {windows.device}")
    W, win = windows.shape
    K = coef.shape[0]
    if block_w * K > MAX_BLOCK_THREADS:
        raise ValueError(f"goertzel_windows: block_w x K = {block_w * K} "
                         f"threads exceed {MAX_BLOCK_THREADS} per block")
    windows, coef = windows.contiguous(), coef.contiguous()
    out = torch.empty((W, K), dtype=torch.float32, device=windows.device)
    WINDOWS_KERNEL.launch(ptr(windows), ptr(coef), ptr(out), W, win, K,
                          block_w, stream_of(windows))
    return out
