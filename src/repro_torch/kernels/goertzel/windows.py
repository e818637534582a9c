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

The kernel's geometry is chosen here and logged once per shape:
``windows_route`` takes "chain" (one window a warp, one warp a block, the
windows spread over the SMs and each chain at its floor) where the chains
are few, and "packed" (floor(32 / K) windows a warp, several warps a
block) where many windows make the bytes the bound.  ``block_w`` is the
reference's contract (W divides into blocks of it) and no longer sets the
geometry.  The kernel refuses a geometry it does not take.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import CudaKernel, ptr, stream_of

WINDOWS_KERNEL = CudaKernel(
    "goertzel/csrc/windows.cu", "windows_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])

#: the most windows x bins a block of block_w windows holds (the
#: wrapper's contract; the kernel's geometry no longer follows block_w)
MAX_BLOCK_THREADS = 1024

# the kernel's constants (csrc/windows.cu)
LANES = 32
STAGES = 4                 # ring slots a warp
PAD = 20                   # floats after each staged row
STAGE_QUANTUM = 32         # a stage is a multiple of two 16-sample reads
MAX_WARPS = 8              # warps a block
BLOCK_SMEM = 48 * 1024     # a block's shared memory, without an opt-in
# the geometry's choices
SMS = 132                  # an H100's SMs
CHAIN_TASKS = 4 * SMS      # at most one walking warp a scheduler
CHAIN_MAX_STAGE = 1024     # the whole window in flight for win <= 4096
PACKED_STAGE_FLOATS = 512  # a packed warp's stage over its rows, 2 KB
PACKED_WARPS = 4

_log = logging.getLogger(__name__)
_routes: Dict[Tuple[int, int, int], "WindowsRoute"] = {}


class WindowsRoute(NamedTuple):
    """The geometry of kernel H at one (W, win, K)."""
    route: str        # "chain" or "packed"
    per_warp: int     # windows a warp's task
    bins: int         # bins a task, min(K, 32): lane j * bins + k
    groups: int       # tasks a window, ceil(K / 32)
    stage: int        # samples a ring slot's row, a multiple of 32
    stages: int       # stages a window, ceil(win / stage)
    warps: int        # warps a block
    blocks: int       # blocks: a task a warp
    smem_bytes: int   # dynamic shared memory a block


def ring_bytes(per_warp: int, stage: int) -> int:
    """A warp's ring in shared memory: STAGES slots of per_warp rows."""
    return 4 * STAGES * per_warp * (stage + PAD)


def _round_up(n: int, q: int = STAGE_QUANTUM) -> int:
    return -(-n // q) * q


def windows_route(W: int, win: int, K: int,
                  route: Optional[str] = None) -> WindowsRoute:
    """Kernel H's geometry for ``[W, win]`` windows and ``K`` bins:
    "chain" where the W ceil(K / 32) tasks of one window fit one warp a
    scheduler of the card (``CHAIN_TASKS``), else "packed"; ``route``
    forces one.  Chain: a stage of ceil(win / STAGES) samples (so the ring
    holds the whole window up to win 4096), one warp a block.  Packed:
    floor(32 / min(K, 32)) windows a warp, about ``PACKED_STAGE_FLOATS``
    samples a stage over them (no more than the window), up to
    ``PACKED_WARPS`` warps a block within ``BLOCK_SMEM``."""
    if W < 1 or win < 1 or K < 1:
        raise ValueError(f"goertzel_windows: W, win and K must be >= 1, "
                         f"got {W}, {win}, {K}")
    bins = min(K, LANES)
    groups = -(-K // LANES)
    if route is None:
        route = "chain" if W * groups <= CHAIN_TASKS else "packed"
    if route == "chain":
        per_warp, warps = 1, 1
        stage = min(CHAIN_MAX_STAGE, _round_up(-(-win // STAGES)))
    elif route == "packed":
        per_warp = LANES // bins
        stage = min(_round_up(-(-PACKED_STAGE_FLOATS // per_warp)),
                    _round_up(win))
        warps = max(1, min(PACKED_WARPS,
                           BLOCK_SMEM // ring_bytes(per_warp, stage)))
    else:
        raise ValueError(f"goertzel_windows: no route {route!r}")
    tasks = -(-W // per_warp) * groups
    return WindowsRoute(route, per_warp, bins, groups, stage,
                        -(-win // stage), warps, -(-tasks // warps),
                        warps * ring_bytes(per_warp, stage))


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
    route = _routes.get((W, win, K))
    if route is None:  # chosen and logged once a shape
        route = _routes[(W, win, K)] = windows_route(W, win, K)
        _log.info("goertzel_windows [%d x %d, K %d]: %s", W, win, K, route)
    return launch_route(windows.contiguous(), coef.contiguous(), route)


def launch_route(windows, coef, route: WindowsRoute):
    """Kernel H on card tensors ``windows`` ``[W, win]`` and ``coef``
    ``[K]`` (contiguous float32) at the geometry ``route``."""
    W, win = windows.shape
    K = coef.shape[0]
    out = torch.empty((W, K), dtype=torch.float32, device=windows.device)
    WINDOWS_KERNEL.launch(ptr(windows), ptr(coef), ptr(out), W, win, K,
                          route.per_warp, route.stage, route.warps,
                          route.blocks, stream_of(windows))
    return out
