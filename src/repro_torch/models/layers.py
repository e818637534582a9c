"""Shared primitives: norms, RoPE, initializers (reference:
``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def dt(name: str) -> torch.dtype:
    return getattr(torch, name)


def rms_norm(x, w, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def group_norm_heads(x, w, b, eps: float):
    """Per-head layer norm used by RWKV6 on the wkv output. x: [..., H, D];
    mean and (population) variance in f32."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w + b).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, D] (D even), positions: broadcastable [..., S].  Angles
    in f32; the two halves of D are rotated as pairs (not interleaved)."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta)).to(x.device)  # [D/2]
    ang = positions[..., None].float() * freqs  # [..., S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers (fan-in scaled normal, the MaxText/Megatron default), drawn
# from an explicit torch.Generator on the generator's device.  They cannot
# repeat the reference's jax.random draws: tests hand both packages the
# same numpy params instead (convert.params_from_reference).
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, dtype, scale: float = 1.0):
    std = scale / np.sqrt(d_in)
    return (_normal(gen, (d_in, d_out)) * std).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype):
    return (_normal(gen, (vocab, d)) * 0.02).to(dtype)


def stack_init(gen, n: int, init_fn: Callable) -> Dict:
    """``n`` draws of ``init_fn(gen)`` stacked on a leading axis (the
    scan-over-layers params).  Each draw is copied into one preallocated
    ``[n, ...]`` tensor per leaf, so the peak is the stack plus one layer."""
    first = init_fn(gen)
    out = _map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                     device=t.device), first)
    _copy_into(out, first, 0)
    del first
    for i in range(1, n):
        _copy_into(out, init_fn(gen), i)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_into(dst, src, i: int) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k], i)
    else:
        dst[i].copy_(src)
