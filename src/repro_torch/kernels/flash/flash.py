"""The flash-attention forward: kernel F of the port and its plain version.

``flash_forward`` computes what the reference's Pallas kernel
``flash_pallas`` (``src/repro/kernels/flash/flash.py``) computes: GQA
attention of q ``[B, S, KV, G, D]`` over k ``[B, T, KV, D]`` and v
``[B, T, KV, Dv]`` (bf16 or f32) into ``[B, S, KV, G, Dv]`` in q's dtype,
with

  * products and accumulators in f32;
  * q scaled by D^-1/2 before QK^T (the model's chunked path scales after);
  * with ``causal``, the mask ``pos_q >= pos_k`` on absolute positions
    (both counted from 0) as a score of NEG = -1e30;
  * the online softmax's running max, sum and accumulator per query row,
    and the output divided by ``max(l, 1e-30)``.

On a CUDA tensor it launches the CUDA kernel (``csrc/flash_fwd.cu``); on a
CPU tensor it runs ``flash_forward_plain``, the reference's blocked online
softmax in torch ops (q blocks of ``q_block``, kv chunks of
``kv_chunk``, all in f32); any other device raises.  The kernel walks kv
in tiles of its own and stops at the diagonal in a causal launch, so it
does not use ``q_block`` and ``kv_chunk`` beyond the reference's
divisibility checks.

The kernel has two instantiations.  f32 keeps the arithmetic above on the
CUDA cores.  bf16 runs on Hopper's tensor cores (``csrc/flash_wgmma.cuh``),
as the reference's dots ran on the TPU's: QK^T of the bf16 q and k with f32
sums, the scale applied to the f32 scores, and P V with P as two bf16
terms (hi and lo) against bf16 v with f32 sums.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, ptr, stream_of

NEG = -1e30

FLASH_KERNEL = CudaKernel(
    "flash/csrc/flash_fwd.cu", "flash_fwd_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, q_block: int, kv_chunk: int) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_forward: q must be [B,S,KV,G,D] and k, v "
                         f"[B,T,KV,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, KV, G, D = q.shape
    T = k.shape[1]
    if tuple(k.shape) != (B, T, KV, D) or tuple(v.shape[:3]) != (B, T, KV):
        raise ValueError(f"flash_forward: k must be {(B, T, KV, D)} and v "
                         f"{(B, T, KV)} + (Dv,); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_forward: q, k, v must share one of "
                         f"{_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_forward: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if S % q_block or T % kv_chunk:
        raise ValueError(f"flash_forward: S={S} must divide into q blocks "
                         f"of {q_block} and T={T} into kv chunks of "
                         f"{kv_chunk}")


def flash_forward_plain(q, k, v, *, q_block: int = 2048,
                        kv_chunk: int = 1024, causal: bool = True):
    """Kernel F's plain version: for each q block, the online softmax over
    kv chunks in order, every chunk visited (masked ones too), in f32."""
    B, S, KV, G, D = q.shape
    T = k.shape[1]
    Dv = v.shape[-1]
    scale = D ** -0.5
    dev = q.device
    out = torch.empty((B, S, KV, G, Dv), dtype=q.dtype, device=dev)
    kf, vf = k.float(), v.float()
    for lo in range(0, S, q_block):
        qb = q[:, lo:lo + q_block].float() * scale       # [B, qb, KV, G, D]
        pos_q = lo + torch.arange(qb.shape[1], device=dev)
        m = torch.full((B, KV, G, qb.shape[1]), NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((*m.shape, Dv), dtype=torch.float32, device=dev)
        for j in range(0, T, kv_chunk):
            s = torch.einsum("bskgd,btkd->bkgst", qb, kf[:, j:j + kv_chunk])
            if causal:
                pos_k = j + torch.arange(kv_chunk, device=dev)
                s = torch.where(pos_q[:, None] >= pos_k[None, :], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            e = torch.exp(s - m_new[..., None])
            l = l * alpha + e.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", e, vf[:, j:j + kv_chunk])
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, lo:lo + q_block] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out


def flash_forward(q, k, v, *, q_block: int = 2048, kv_chunk: int = 1024,
                  causal: bool = True):
    """Attention of q over k, v; see the module docstring."""
    _check(q, k, v, q_block, kv_chunk)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, q_block=q_block,
                                   kv_chunk=kv_chunk, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: no kernel for {q.device}")
    B, S, KV, G, D = q.shape
    T, Dv = k.shape[1], v.shape[-1]
    scale = D ** -0.5
    bf16 = q.dtype == torch.bfloat16
    q, k, v = (_kernel_operand(t, bf16) for t in (q, k, v))
    Dk, Dvk = q.shape[-1], v.shape[-1]
    out = torch.empty((B, S, KV, G, Dvk), dtype=q.dtype, device=q.device)
    FLASH_KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), B, S, T, KV, G, Dk,
                        Dvk, int(causal), scale, int(bf16), stream_of(q))
    return out if Dvk == Dv else out[..., :Dv].contiguous()


def _kernel_operand(t, bf16: bool):
    """``t`` as the kernel reads it: contiguous, and for bf16 (whose rows the
    TMA and 16-byte loads move) on a 16-byte boundary with a last dim that
    is a multiple of 8, zero-padded where it is 4 mod 8.  The zero columns
    add nothing to q k^T, and a zero column of v gives an output column the
    wrapper drops."""
    t = t.contiguous()
    if not bf16:
        return t
    if t.shape[-1] % 8:
        t = torch.nn.functional.pad(t, (0, 8 - t.shape[-1] % 8))
    if t.data_ptr() % 16:
        t = t.clone()
    return t
