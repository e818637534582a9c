"""RWKV-6's wkv recurrence: kernel M of the port and its plain version.

``wkv6(r, k, v, w, u, S0)`` runs, for each batch row and head, over the
time steps t (the reference's ``lax.scan`` in ``repro/models/rwkv.py``),
with the state S ``[hd_k, hd_v]``::

    kv_ij = k_i v_j
    y_j   = sum_i r_i (S_ij + u_i kv_ij)
    S_ij  = w_i S_ij + kv_ij

with ``r``, ``k``, ``v [B, T, H, hd]`` in the compute dtype (f32 or bf16),
the decay ``w [B, T, H, hd]``, ``u [H, hd]`` and ``S0 [B, H, hd, hd]`` in
f32; it returns ``y [B, T, H, hd]`` and ``S_last [B, H, hd, hd]``, both f32.

On a CUDA tensor it launches the CUDA kernel (``csrc/wkv6.cu``) and counts
the launch; on a CPU tensor it runs ``wkv6_plain``, a loop over T in torch
ops, the same arithmetic, which autograd differentiates; any other device
raises.  The kernel takes head dims 8, 16, 32 and 64 (a row of r under 16
bytes would need copies narrower than its 16-byte ``cp.async``; the zoo's
head dims are 64 and, reduced, 16).  It has no backward yet: on the card,
inputs that require a gradient raise ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, aligned16, ptr, stream_of

WKV6_KERNEL = CudaKernel(
    "scans/csrc/wkv6.cu", "wkv6_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

# the head dims the kernel is built for
HEAD_DIMS = (8, 16, 32, 64)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(r, k, v, w, u, S0) -> None:
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be [B, T, H, hd]; got "
                         f"{tuple(r.shape)}")
    B, T, H, hd = r.shape
    want = {"k": (k, (B, T, H, hd)), "v": (v, (B, T, H, hd)),
            "w": (w, (B, T, H, hd)), "u": (u, (H, hd)),
            "S0": (S0, (B, H, hd, hd))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"wkv6: {name} must be {shape}; got "
                             f"{tuple(t.shape)}")
        if t.device != r.device:
            raise ValueError(f"wkv6: r on {r.device}, {name} on {t.device}")


def wkv6_plain(r, k, v, w, u, S0):
    """Kernel M's plain version: a loop over T in the dtype of ``S0`` (f32;
    float64 for an oracle), each product and sum in the reference's order.
    Returns ``(y, S_last)``."""
    f = S0.dtype
    r, k, v, w, u = (t.to(f) for t in (r, k, v, w, u))
    S = S0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # [B, H, k, v]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else r.new_zeros(r.shape)
    return y, S


def wkv6(r, k, v, w, u, S0):
    """``(y, S_last)`` of the wkv recurrence (module docstring)."""
    _check(r, k, v, w, u, S0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, S0.to(torch.float32))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, S0)):
        raise NotImplementedError(
            "the backward of the wkv kernel (kernel M) is not ported yet: "
            "run it under torch.no_grad() on the card, or on the CPU")
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: tensors on {r.device}: the kernel takes "
                         "CUDA tensors, the plain version CPU ones")
    kernel_check(r, k, v, w, u, S0)
    B, T, H, hd = r.shape
    r, k, v, w = (aligned16(t) for t in (r, k, v, w))
    u, S0 = u.contiguous(), S0.contiguous()
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    S_last = torch.empty((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    if T == 0:
        S_last.copy_(S0)
        return y, S_last
    WKV6_KERNEL.launch(ptr(r), ptr(k), ptr(v), ptr(w), ptr(u), ptr(S0),
                       ptr(y), ptr(S_last), B, T, H, hd,
                       int(r.dtype == torch.bfloat16), stream_of(r))
    return y, S_last


def kernel_check(r, k, v, w, u, S0) -> None:
    """Refuses, on any device, the dtypes and head dims the kernel does not
    take (shapes are ``_check``'s)."""
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r, k, v must share one of {_DTYPES}; got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in (w, u, S0)):
        raise ValueError(f"wkv6: w, u, S0 must be f32; got {w.dtype}, "
                         f"{u.dtype}, {S0.dtype}")
    if r.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"wkv6: head_dim {r.shape[-1]} is not one of "
                         f"{HEAD_DIMS}")

