"""The ballast GEMM burner: kernel G of the port and its plain version.

``ballast`` computes what the reference's Pallas kernel ``ballast_pallas``
(``src/repro/kernels/ballast/ballast.py``) computes: from C = ``a``
``[M, K]``, ``n_iter`` steps of C <- (C ``b``) ``decay`` with ``b``
``[K, N]``, in float32 (``a`` and ``b`` may be float32 or bfloat16 and
are widened on load), into ``[M, N]`` float32.  As the reference asserts,
``b`` is square (K == N) and ``M`` divides into blocks of ``bm`` rows;
the kernel takes its own row blocks and does not use ``bm`` beyond that
check.

On a CUDA tensor it launches the CUDA kernel (``csrc/ballast.cu``, f32
FFMA, no TF32) by one of two routes, chosen by ``b``'s width
(``ballast_route``): "cluster", which keeps ``b`` in the shared memory of
a thread-block cluster for the whole burn, where its column slices fit
(N in ``CLUSTER_SIZE``), else "stream", which reads ``b`` from L2 at
every step.  Both sum each output's products in the same order, so they
give the same bits.  On a CPU tensor it runs ``ballast_plain``, the chain
of float32 ``torch.matmul``s; any other device raises.
"""
from __future__ import annotations

import ctypes
import logging

import torch

from repro_torch.kernels.ballast.ref import ballast_ref
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

BALLAST_KERNEL = CudaKernel(
    "ballast/csrc/ballast.cu", "ballast_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
#: the widest ``b`` the kernel takes (route "stream": one thread a column)
MAX_N = 1024
#: route "cluster"'s geometries: N -> blocks a cluster, each holding an
#: [N x N / c] slice of ``b`` (``csrc/ballast.cu``, ``dispatch_cluster``)
CLUSTER_SIZE = {64: 1, 128: 2, 256: 2}

_log = logging.getLogger(__name__)
_logged = set()


def ballast_route(N: int) -> str:
    """Kernel G's route for a ``b`` of width ``N``: "cluster" for N in
    ``CLUSTER_SIZE``, else "stream"; raises for an N the kernel does not
    take (N > ``MAX_N`` or N % 4)."""
    if N > MAX_N or N % 4:
        raise ValueError(f"ballast: the kernel takes N <= {MAX_N} and a "
                         f"multiple of 4, got N={N}")
    return "cluster" if N in CLUSTER_SIZE else "stream"


def launch_route(a, b, n_iter: int, decay: float, route: str):
    """Launch kernel G by ``route`` on contiguous operands already checked
    by ``ballast``; returns C ``[M, N]`` f32.  ``ballast`` calls it with
    ``ballast_route``'s choice; ``chip_smoke.py`` with either route to time
    and compare them."""
    M, N = a.shape[0], b.shape[1]
    if route == "cluster":
        cluster = CLUSTER_SIZE[N]
    elif route == "stream":
        cluster = 0
    else:
        raise ValueError(f"ballast: no route {route!r}")
    if (route, N, cluster) not in _logged:
        _logged.add((route, N, cluster))
        _log.info("ballast: route %s for N=%d%s", route, N,
                  f", clusters of {cluster}" if cluster else "")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    BALLAST_KERNEL.launch(ptr(a), ptr(b), ptr(out), M, N, int(n_iter),
                          float(decay), int(a.dtype == torch.bfloat16),
                          int(b.dtype == torch.bfloat16), int(cluster),
                          stream_of(a))
    return out


def _check(a, b, bm: int) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"ballast: a must be [M, K] and b [K, N]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    M, K = a.shape
    K2, N = b.shape
    if not K == K2 == N:
        raise ValueError(f"ballast: the iterated burner needs a square "
                         f"multiplier, K == N; got a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if bm < 1 or M % bm:
        raise ValueError(f"ballast: M={M} must divide into blocks of "
                         f"bm={bm}")
    if a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise ValueError(f"ballast: a and b must each be one of {_DTYPES}; "
                         f"got {a.dtype}, {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"ballast: a on {a.device}, b on {b.device}")


def ballast_plain(a, b, n_iter: int, *, bm: int = 256,
                  decay: float = 0.999):
    """Kernel G's plain version: the ``n_iter`` float32 matmuls."""
    del bm
    return ballast_ref(a, b, n_iter, decay)


def ballast(a, b, n_iter: int, *, bm: int = 256, decay: float = 0.999):
    """C ``[M, N]`` f32 after ``n_iter`` steps; see the module docstring."""
    _check(a, b, bm)
    if a.device.type == "cpu":
        return ballast_plain(a, b, n_iter, bm=bm, decay=decay)
    if a.device.type != "cuda":
        raise ValueError(f"ballast: no kernel for {a.device}")
    route = ballast_route(b.shape[1])
    return launch_route(a.contiguous(), b.contiguous(), n_iter, decay, route)
