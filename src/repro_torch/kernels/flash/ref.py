"""The float64 dense oracle of the flash kernel (same layouts).

The reference's ``flash_ref`` is the model's dense sdpa in the working
dtype; this one computes exact softmax attention in float64, one block of
queries at a time so that full-length scores never exist at once.
"""
from __future__ import annotations

import torch


def flash_ref(q, k, v, *, causal: bool = True, block: int = 512):
    """q: [B,S,KV,G,D]; k,v: [B,T,KV,D] -> float64 [B,S,KV,G,Dv]."""
    B, S, KV, G, D = q.shape
    T, Dv = k.shape[1], v.shape[-1]
    k64, v64 = k.double(), v.double()
    pos_k = torch.arange(T, device=q.device)
    out = torch.empty((B, S, KV, G, Dv), dtype=torch.float64, device=q.device)
    for lo in range(0, S, block):
        q64 = q[:, lo:lo + block].double()
        s = torch.einsum("bskgd,btkd->bkgst", q64, k64) * D ** -0.5
        if causal:
            pos_q = lo + torch.arange(q64.shape[1], device=q.device)
            s = s.masked_fill(pos_q[:, None] < pos_k[None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[:, lo:lo + block] = torch.einsum("bkgst,btkd->bskgd", p, v64)
    return out
