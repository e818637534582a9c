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
(``csrc/sliding.cu`` on ``csrc/sliding_walk.cuh``, shared with kernel I);
on a CPU tensor it runs ``sliding_bin_power_v2_plain``, which walks the
segments in order with ``torch.cumsum``; any other device raises.

The kernel's geometry is chosen here, for kernels E and I alike, and
logged once per shape: ``sliding_route`` (a cluster of C = min(K, 8)
blocks, bins in parallel; the resident walk over groups of segments or
one segment a cluster in rounds of J columns; the shared memory a block),
``segment_groups`` (segments a cluster walks, from the clusters the card
holds at once) and ``store_slices`` (which samples each block of a
cluster stores).  The kernel refuses a geometry it does not take.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.core.telemetry import warmup_scale
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

SLIDING_KERNEL = CudaKernel(
    "goertzel/csrc/sliding.cu", "sliding_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p])

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# the kernel's constants (csrc/goertzel_scan.cuh, goertzel_tiles.cuh,
# sliding_walk.cuh)
THREADS = 256             # a block; each thread owns a run of samples
MAX_CLUSTER = 8           # the portable cluster size
TILES = 6                 # [256, Q] tiles a block in the resident walk
WALK_FIELDS = 4           # general path, per thread and bin: pr, pi, qr, qi
STORE_FLOATS_PER_BIN = 8 * 32  # staging: 8 warps x 32 samples, per bin
SMEM_OPTIN = 232_448      # shared memory a block may opt into on an H100
STATIC_ROOM = 1024        # kept for the kernel's static shared memory

_log = logging.getLogger(__name__)
_logged: set = set()
_active: Dict[Tuple[str, int, int], int] = {}


class SlidingRoute(NamedTuple):
    """The geometry of kernels E and I at one (win, K)."""
    resident: bool    # walk groups of segments, the previous table kept
    cluster: int      # blocks a cluster, C = min(K, 8)
    nbins: int        # bins a block (rank c takes c, c + C, ...)
    chunk: int        # samples a thread's run, ceil(win / 256)
    J: int            # run columns staged a round
    Q: int            # tile row stride
    rounds: int       # ceil(chunk / J)
    smem_bytes: int   # dynamic shared memory a block


def row_stride(cols: int) -> int:
    """The least tile row stride >= cols with Q = 4 (mod 8)."""
    q = (cols + 3) & ~3
    return q + 4 if q % 8 == 0 else q


def walk_bytes(resident: bool, J: int, nbins: int, K: int) -> int:
    """Dynamic shared memory a block (``walk_bytes`` in sliding_walk.cuh):
    six tiles resident, else five and one amplitude tile a bin with the
    fields carried across rounds and the totals; then the staging area of
    the interleaved stores."""
    tq = THREADS * row_stride(J)
    tiles = TILES * tq if resident else (5 + nbins) * tq
    fields = 0 if resident else nbins * (WALK_FIELDS * THREADS + 2)
    return 4 * (tiles + STORE_FLOATS_PER_BIN * K + fields)


def sliding_route(win: int, K: int) -> SlidingRoute:
    """The geometry of kernels E and I at window ``win`` and ``K`` bins:
    resident when one bin a block and six whole-run tiles fit a block's
    shared memory (``SMEM_OPTIN`` less ``STATIC_ROOM``), else one segment
    a cluster with the widest rounds of J columns that fit; raises where
    none fits."""
    if win < 1 or K < 1:
        raise ValueError(f"sliding: win and K must be >= 1, got {win}, {K}")
    C = min(K, MAX_CLUSTER)
    nbins = -(-K // C)
    chunk = -(-win // THREADS)
    room = SMEM_OPTIN - STATIC_ROOM
    J = (chunk + 3) & ~3
    resident = nbins == 1 and walk_bytes(True, J, 1, K) <= room
    if not resident:
        while J > 4 and walk_bytes(False, J, nbins, K) > room:
            J -= 4
        if walk_bytes(False, J, nbins, K) > room:
            raise ValueError(f"sliding: K={K} bins do not fit a block's "
                             f"shared memory")
    return SlidingRoute(resident, C, nbins, chunk, J, row_stride(J),
                        -(-chunk // J), walk_bytes(resident, J, nbins, K))


def segment_groups(B: int, S: int, active: int) -> Tuple[int, int]:
    """(segments a cluster walks, clusters a row) in the resident walk:
    the fewest waves of ``active`` resident clusters, a cluster's work its
    segments plus one for a group that starts past segment 0 (kernel A's
    ``group_size``)."""
    best, best_cost = S, None
    for m in range(1, S + 1):
        clusters = B * -(-S // m)
        cost = -(-clusters // active) * (m + (1 if m < S else 0))
        if best_cost is None or cost < best_cost:
            best, best_cost = m, cost
    return best, -(-S // best)


def store_slices(win: int, route: SlidingRoute
                 ) -> List[List[Tuple[int, List[int]]]]:
    """Which samples each block of a cluster stores (``store_round`` in
    sliding_walk.cuh): per round, per block rank, the first position of its
    slice and its samples in order.  Positions e = t * jr + j of a round
    (column c0 + j of thread t's run, sample t * chunk + c0 + j; in one
    round the position is the sample); rank c takes positions
    [4 floor(E4 c / C), 4 floor(E4 (c + 1) / C)), E4 = ceil(E / 4)."""
    C, chunk = route.cluster, route.chunk
    out = []
    for r in range(route.rounds):
        c0 = r * route.J
        jr = min(route.J, chunk - c0)
        E = win if jr == chunk else THREADS * jr
        E4 = -(-E // 4)
        rnd = []
        for c in range(C):
            e_lo, e_hi = 4 * (E4 * c // C), min(E, 4 * (E4 * (c + 1) // C))
            samples = [(e // jr) * chunk + c0 + e % jr
                       for e in range(e_lo, e_hi)]
            rnd.append((e_lo, [gi for gi in samples if gi < win]))
        out.append(rnd)
    return out


def launch_geometry(kernel: CudaKernel, query: str, B: int, S: int,
                    win: int, K: int) -> Tuple[SlidingRoute, int]:
    """The route and the group size of a launch of kernel E or I, the
    clusters the card holds at once from the library's ``query``; logged
    once per shape."""
    route = sliding_route(win, K)
    group = 1
    if route.resident and S > 1:
        key = (query, K, route.smem_bytes)
        if key not in _active:
            n = kernel.call(query, [ctypes.c_int, ctypes.c_longlong], K,
                            route.smem_bytes)
            if n <= 0:
                raise RuntimeError(f"{query}: no cluster of {route.cluster}"
                                   f" blocks fits the card (error {-n})")
            _active[key] = n
        group = segment_groups(B, S, _active[key])[0]
    if (kernel.name, B, S, win, K) not in _logged:
        _logged.add((kernel.name, B, S, win, K))
        _log.info("%s [%d x %d x %d, K %d]: %s, group %d", kernel.name, B, S,
                  win, K, route, group)
    return route, group


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
    route, group = launch_geometry(SLIDING_KERNEL, "sliding_active_clusters",
                                   B, S, win, K)
    SLIDING_KERNEL.launch(*(ptr(t) for t in args), ptr(amps), ptr(nre),
                          ptr(nim), B, S, win, K, int(route.resident),
                          route.J, group, stream_of(xseg))
    return amps, nre, nim
