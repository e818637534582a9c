"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``kernels/<family>/csrc/<name>.cu`` exports a plain C
entry point (or two, such as a forward and its adjoint: two
``CudaKernel``s of one source, each with its own name and launch count).  It is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library, at first use, and loaded with ``ctypes``; pointers and
the stream cross as Python ints.  The library's file name carries a hash
of the source, the headers beside it and the flags, so an edited source
or header is rebuilt.  Libraries go to
``build/kernels`` at the root of the checkout, a directory git ignores.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_ROOT.parents[1] / "build" / "kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# every CudaKernel, so a caller can build them all at once and read or
# reset their launch counts
KERNELS: List["CudaKernel"] = []

# one lock a library, held across its first build and load: two threads
# that reach a cold kernel together build it once, and the second waits
_LIBRARY_LOCKS: Dict[Path, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _library_lock(path: Path) -> threading.Lock:
    with _LOCKS_LOCK:
        return _LIBRARY_LOCKS.setdefault(path, threading.Lock())


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One C entry point of one ``.cu`` source.

    ``launch(*args)`` builds and loads the library on first use, calls the
    entry (which enqueues the kernel on the given stream and returns
    ``cudaGetLastError()``), raises if that is not 0, and only then adds
    one to ``launches``.  The first build and load hold the library's
    lock, and the count its own, so threads may launch at once.  ``argtypes`` are ctypes types; pass pointers and
    the stream as ``ctypes.c_void_p`` so they are not cut to 32 bits.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 extra_flags: Sequence[str] = (), name: Optional[str] = None):
        self.source = PACKAGE_ROOT / "kernels" / source
        self._name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.extra_flags = tuple(extra_flags)
        self.launches = 0
        self._count_lock = threading.Lock()
        self.build_seconds: Optional[float] = None
        self.ptxas_log = ""
        self._fn = None
        KERNELS.append(self)

    @property
    def name(self) -> str:
        """The launch-count name: the source's stem, or the name given for
        a second entry point of one library."""
        return self._name or self.source.stem

    def _flags(self) -> List[str]:
        return [*ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo",
                "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                *self.extra_flags]

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(self._flags()).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:12]}.so"

    def _tmp_path(self) -> Path:
        """Where ``nvcc`` writes before the rename: one name a process and
        a thread."""
        return self.library_path().with_suffix(
            f".{os.getpid()}-{threading.get_ident()}.tmp")

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library exists;
        returns the running process (``finish_build`` waits for it)."""
        if self.library_path().exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self._tmp_path()
        self._t0 = time.perf_counter()
        return subprocess.Popen(
            [nvcc_path(), *self._flags(), "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.ptxas_log = out
        tmp = self._tmp_path()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{out}")
        os.replace(tmp, self.library_path())
        self.build_seconds = time.perf_counter() - self._t0

    def _load(self):
        if self._fn is None:
            with _library_lock(self.library_path()):
                if self._fn is None:
                    self.finish_build(self.start_build())
                    lib = ctypes.CDLL(str(self.library_path()))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._fn = fn
        return self._fn

    def call(self, symbol: str, argtypes: Sequence, *args) -> int:
        """Call another C function of this kernel's library (a query such as
        an occupancy: it launches nothing, so ``launches`` does not move);
        returns its int."""
        self._load()
        fn = getattr(ctypes.CDLL(str(self.library_path())), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn(*args)

    def launch(self, *args) -> None:
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} at launch")
        with self._count_lock:
            self.launches += 1


def build_all() -> Dict[str, float]:
    """Build every kernel's library at once (one ``nvcc`` per source, all
    started together) and load them; returns build seconds by kernel
    (0.0 for a library that was already built)."""
    started = set()
    procs = []
    for k in KERNELS:
        # entry points of one library share its one nvcc
        path = k.library_path()
        procs.append((k, None if path in started else k.start_build()))
        started.add(path)
    for k, proc in procs:
        k.finish_build(proc)
        k._load()
    return {k.name: (k.build_seconds or 0.0) for k in KERNELS}


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def aligned16(t):
    """``t`` contiguous and 16-byte aligned (a copy where it is not), for a
    kernel that moves 16 bytes at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
