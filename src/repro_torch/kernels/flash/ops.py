"""The wrapper with shape-adaptive blocks (reference:
``repro/kernels/flash/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.flash.flash import flash_forward


def flash_sdpa(q, k, v, *, causal: bool = True, q_block: int = 2048,
               kv_chunk: int = 1024):
    """q: [B,S,KV,G,D]; k,v: [B,T,KV,D] -> [B,S,KV,G,Dv].  Blocks are
    clamped to the sequence lengths, as in the reference."""
    S, T = q.shape[1], k.shape[1]
    q_block = min(q_block, S)
    kv_chunk = min(kv_chunk, T)
    return flash_forward(q, k, v, q_block=q_block, kv_chunk=kv_chunk,
                         causal=causal)
