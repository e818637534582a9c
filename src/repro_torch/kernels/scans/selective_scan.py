"""Mamba's selective scan (S6): kernel L of the port and its plain version.

``selective_scan(xi, dt, Bc, Cc, A, h0)`` runs, for each batch row and
inner channel d, over the time steps t (the reference's ``lax.scan`` in
``repro/models/mamba.py``)::

    dA  = exp(dt[t, d] * A[d, s])
    h_s = dA * h_s + (dt[t, d] * Bc[t, s]) * xi[t, d]
    y[t, d] = sum_s h_s * Cc[t, s]

with ``xi [B, T, di]``, ``Bc``, ``Cc [B, T, ds]`` in the compute dtype (f32
or bf16), ``dt [B, T, di]``, ``A [di, ds]`` and ``h0 [B, di, ds]`` in f32;
it returns ``ys [B, T, di]`` and ``h_last [B, di, ds]``, both f32.

On a CUDA tensor it launches the CUDA kernel (``csrc/selective_scan.cu``)
and counts the launch; on a CPU tensor it runs ``selective_scan_plain``, a
loop over T in torch ops, the same arithmetic, which autograd
differentiates; any other device raises.  The kernel takes d_state 8 and
16, and in bf16 an even d_inner (its narrowest copy, 4 bytes, holds two
channels; Mamba's d_inner is expand x d_model).  It has no backward yet:
on the card, inputs that require a gradient raise ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, aligned16, ptr, stream_of

SELECTIVE_SCAN_KERNEL = CudaKernel(
    "scans/csrc/selective_scan.cu", "selective_scan_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

# the state sizes the kernel is built for
D_STATES = (8, 16)
_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 65535  # batch rows: the grid's second dimension


def _check(xi, dt, Bc, Cc, A, h0) -> None:
    if xi.dim() != 3:
        raise ValueError(f"selective_scan: xi must be [B, T, di]; got "
                         f"{tuple(xi.shape)}")
    B, T, di = xi.shape
    ds = A.shape[-1] if A.dim() == 2 else -1
    want = {"dt": (dt, (B, T, di)), "Bc": (Bc, (B, T, ds)),
            "Cc": (Cc, (B, T, ds)), "A": (A, (di, ds)),
            "h0": (h0, (B, di, ds))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} must be {shape}; got "
                             f"{tuple(t.shape)}")
        if t.device != xi.device:
            raise ValueError(f"selective_scan: xi on {xi.device}, {name} on "
                             f"{t.device}")


def selective_scan_plain(xi, dt, Bc, Cc, A, h0):
    """Kernel L's plain version: a loop over T in the dtype of ``h0`` (f32;
    float64 for an oracle), each product and sum in the reference's order.
    Returns ``(ys, h_last)``."""
    f = h0.dtype
    x, d, b, c, a = (t.to(f) for t in (xi, dt, Bc, Cc, A))
    h = h0
    ys = []
    for t in range(xi.shape[1]):
        dt_t = d[:, t, :, None]                          # [B, di, 1]
        dA = torch.exp(dt_t * a[None])                   # [B, di, ds]
        dBx = dt_t * b[:, t, None, :] * x[:, t, :, None]
        h = dA * h + dBx
        ys.append(torch.einsum("bds,bs->bd", h, c[:, t]))
    ys = torch.stack(ys, dim=1) if ys else x.new_zeros(xi.shape)
    return ys, h


def selective_scan(xi, dt, Bc, Cc, A, h0):
    """``(ys, h_last)`` of the selective scan (module docstring)."""
    _check(xi, dt, Bc, Cc, A, h0)
    if xi.device.type == "cpu":
        return selective_scan_plain(xi, dt, Bc, Cc, A, h0.to(torch.float32))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xi, dt, Bc, Cc, A, h0)):
        raise NotImplementedError(
            "the backward of the selective scan kernel (kernel L) is not "
            "ported yet: run it under torch.no_grad() on the card, or on "
            "the CPU")
    if xi.device.type != "cuda":
        raise ValueError(f"selective_scan: tensors on {xi.device}: the "
                         "kernel takes CUDA tensors, the plain version CPU "
                         "ones")
    kernel_check(xi, dt, Bc, Cc, A, h0)
    B, T, di = xi.shape
    ds = A.shape[-1]
    xi, dt, Bc, Cc = (aligned16(t) for t in (xi, dt, Bc, Cc))
    A, h0 = A.contiguous(), h0.contiguous()
    ys = torch.empty((B, T, di), dtype=torch.float32, device=xi.device)
    h_last = torch.empty((B, di, ds), dtype=torch.float32, device=xi.device)
    if T == 0:
        h_last.copy_(h0)
        return ys, h_last
    SELECTIVE_SCAN_KERNEL.launch(
        ptr(xi), ptr(dt), ptr(Bc), ptr(Cc), ptr(A), ptr(h0), ptr(ys),
        ptr(h_last), B, T, di, ds, int(xi.dtype == torch.bfloat16),
        stream_of(xi))
    return ys, h_last


def kernel_check(xi, dt, Bc, Cc, A, h0) -> None:
    """Refuses, on any device, the dtypes and shapes the kernel does not
    take (the shapes' agreement is ``_check``'s)."""
    B, _, di = xi.shape
    if xi.dtype not in _DTYPES or Bc.dtype != xi.dtype \
            or Cc.dtype != xi.dtype:
        raise ValueError(f"selective_scan: xi, Bc, Cc must share one of "
                         f"{_DTYPES}; got {xi.dtype}, {Bc.dtype}, "
                         f"{Cc.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, h0)):
        raise ValueError(f"selective_scan: dt, A, h0 must be f32; got "
                         f"{dt.dtype}, {A.dtype}, {h0.dtype}")
    if A.shape[-1] not in D_STATES:
        raise ValueError(f"selective_scan: d_state {A.shape[-1]} is not one "
                         f"of {D_STATES}")
    if xi.dtype == torch.bfloat16 and di % 2:
        raise ValueError(f"selective_scan: d_inner {di} must be even in "
                         "bf16 (a 4-byte copy holds two channels)")
    if B > MAX_ROWS:
        raise ValueError(f"selective_scan: {B} batch rows, over {MAX_ROWS}")

