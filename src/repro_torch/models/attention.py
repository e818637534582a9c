"""Attention mixers: GQA (dense, KV-chunked online softmax, and the flash
kernel route) and DeepSeek-V2's Multi-head Latent Attention (reference:
``repro/models/attention.py``).

Layouts, as in the reference:
  activations      x      [B, S, d]
  queries          q      [B, S, KV, G, D]   (KV*G = n_q_heads)
  keys/values      k, v   [B, T, KV, D]
  decode KV cache  ck, cv [B, KV, S_max, D]
  MLA decode cache ckv [B, S_max, kv_lora_rank], krope [B, S_max, rope]

``sdpa`` picks the reference's branch under the reference's conditions:
the flash kernel (``kernels/flash``, kernel F) only when the caller's
``Ctx`` sets ``flash`` and S == T, S % q_chunk == 0, T % chunk == 0 and
S > chunk.  The reference computes its einsums with
``preferred_element_type=float32``; here the operands are cast to f32
before the product, which is the same arithmetic (a product of two bf16
values is exact in f32).

MLA's full-sequence form (``mla_forward``) expands the latent into
per-head K ``[qk_nope | rope]`` (192) and V (128) and goes through ``sdpa``
as MHA (KV = H, G = 1), so its flash route runs kernel F at D 192, Dv 128;
its decode (``mla_decode``) is the weight-absorbed form that attends in
the latent space.

Only kv-head duplication factor 1 is ported: duplication exists for
tensor-parallel sharding, which is the ``parallel/`` slice.
Cross-attention is not ported (``models/model.py`` raises for it).

In place, unlike the reference: ``_write_prefill_cache`` and
``mla_forward`` fill the cache slices they are given (``make_prefill``
hands them freshly allocated ones, so the caller's cache is untouched),
and ``attn_decode`` and ``mla_decode`` write the new token's entries into
the given cache and return it.  A full-width f32
cache is 5.4 GB; a functional copy per decode step would double it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, dense_init, rms_norm

F32 = torch.float32
NEG = -1e30


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def init_attn(gen, cfg, dtype):
    a = cfg.attention
    d = cfg.d_model
    p = {
        "wq": dense_init(gen, d, a.n_heads * a.head_dim, dtype).reshape(d, a.n_heads, a.head_dim),
        "wk": dense_init(gen, d, a.n_kv_heads * a.head_dim, dtype).reshape(d, a.n_kv_heads, a.head_dim),
        "wv": dense_init(gen, d, a.n_kv_heads * a.head_dim, dtype).reshape(d, a.n_kv_heads, a.head_dim),
        "wo": dense_init(gen, a.n_heads * a.head_dim, d, dtype).reshape(a.n_heads, a.head_dim, d),
    }
    if a.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((a.n_heads, a.head_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((a.n_kv_heads, a.head_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((a.n_kv_heads, a.head_dim), dtype=dtype, device=dev)
    return p


def init_mla(gen, cfg, dtype):
    a, m = cfg.attention, cfg.mla
    d = cfg.d_model
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": dense_init(gen, d, a.n_heads * qk_dim, dtype).reshape(d, a.n_heads, qk_dim),
        "wdkv": dense_init(gen, d, m.kv_lora_rank, dtype),
        "wkr": dense_init(gen, d, m.qk_rope_head_dim, dtype),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=gen.device),
        "wuk": dense_init(gen, m.kv_lora_rank, a.n_heads * m.qk_nope_head_dim, dtype).reshape(m.kv_lora_rank, a.n_heads, m.qk_nope_head_dim),
        "wuv": dense_init(gen, m.kv_lora_rank, a.n_heads * m.v_head_dim, dtype).reshape(m.kv_lora_rank, a.n_heads, m.v_head_dim),
        "wo": dense_init(gen, a.n_heads * m.v_head_dim, d, dtype).reshape(a.n_heads, m.v_head_dim, d),
    }


# ---------------------------------------------------------------------------
# Core scaled-dot-product attention over [B,S,KV,G,D] queries
# ---------------------------------------------------------------------------

def _dense_sdpa(q, k, v, pos_q, pos_k, causal, scale):
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if causal:
        mask = pos_q[:, None] >= pos_k[None, :]
        s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _chunked_sdpa(q, k, v, pos_q, causal, scale, chunk):
    """Online-softmax (flash-style) loop over KV chunks; f32 accumulators.

    Keeps peak memory at O(S*chunk) per head instead of O(S*T).
    """
    B, S, KV, G, D = q.shape
    Dv = v.shape[-1]  # may differ from D (MLA: qk 192 vs v 128)
    T = k.shape[1]
    n = T // chunk
    assert n * chunk == T, (T, chunk)
    qf = q.float()
    m = torch.full((B, KV, G, S), NEG, dtype=F32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=F32, device=q.device)
    acc = torch.zeros((B, KV, G, S, Dv), dtype=F32, device=q.device)
    for i in range(n):
        k_c = k[:, i * chunk:(i + 1) * chunk]
        v_c = v[:, i * chunk:(i + 1) * chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qf, k_c.float()) * scale
        if causal:
            pos_kc = i * chunk + torch.arange(chunk, device=q.device)
            mask = pos_q[:, None] >= pos_kc[None, :]
            s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        l = l * alpha + e.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", e, v_c.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # -> [B,S,KV,G,Dv]


def _q_chunked_sdpa(q, k, v, pos_q, causal, scale, chunk, q_chunk):
    """Outer loop over q blocks, inner online-softmax loop over KV chunks
    (the reference's perf iteration #1: accumulators stay [.., q_chunk, D])."""
    S = q.shape[1]
    outs = [_chunked_sdpa(q[:, lo:lo + q_chunk], k, v, pos_q[lo:lo + q_chunk],
                          causal, scale, chunk)
            for lo in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1)


def sdpa(q, k, v, *, pos_q, causal=True, chunk=1024, q_chunk=2048,
         flash=False):
    """q:[B,S,KV,G,D] k,v:[B,T,KV,D] -> [B,S,KV,G,Dv]."""
    T = k.shape[1]
    S = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    pos_k = torch.arange(T, device=q.device)
    if (flash and S == T and S % q_chunk == 0 and T % chunk == 0
            and S > chunk):
        # kernel F, the hand-written flash-attention forward
        from repro_torch.kernels.flash.flash import flash_forward
        return flash_forward(q, k, v, q_block=q_chunk, kv_chunk=chunk,
                             causal=causal)
    if T <= chunk or T % chunk != 0:
        return _dense_sdpa(q, k, v, pos_q, pos_k, causal, scale)
    if S > q_chunk and S % q_chunk == 0:
        return _q_chunked_sdpa(q, k, v, pos_q, causal, scale, chunk, q_chunk)
    return _chunked_sdpa(q, k, v, pos_q, causal, scale, chunk)


def _group(q, kv_heads):
    """[B,S,H,D] -> [B,S,KV,G,D]."""
    B, S, H, D = q.shape
    return q.reshape(B, S, kv_heads, H // kv_heads, D)


def _repeat_kv(k, r, ctx):
    if r == 1:
        return k
    raise NotImplementedError(
        "kv-head duplication (kv_repeat > 1) serves tensor-parallel "
        "sharding, which is not ported yet: ROADMAP queue A, parallel/ on "
        "torch.distributed")


def _project(p, x, a):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dmk->bsmk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dmk->bsmk", x, p["wv"].to(x.dtype))
    if a.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def attn_forward(p, x, ctx, *, cache=None):
    """Self-attention over the full sequence. Returns (out, new_cache)."""
    a = ctx.cfg.attention
    r = ctx.kv_repeat
    q, k, v = _project(p, x, a)
    pos = ctx.positions  # [S]
    q = apply_rope(q, pos[None, :, None], a.rope_theta)
    k = apply_rope(k, pos[None, :, None], a.rope_theta)
    k_pre, v_pre = k, v  # pre-duplication layout (decode-cache layout)
    k, v = _repeat_kv(k, r, ctx), _repeat_kv(v, r, ctx)
    q = _group(q, a.n_kv_heads * r)
    out = sdpa(q, k, v, pos_q=pos, causal=True, chunk=a.chunk_size,
               flash=ctx.flash)
    out = torch.einsum("bskgd,kgde->bse", out,
                       _group_w(p["wo"], a.n_kv_heads * r).to(x.dtype))
    new_cache = None
    if cache is not None:
        new_cache = _write_prefill_cache(cache, k_pre, v_pre, ctx)
    return out, new_cache


def _group_w(wo, kv):
    H, D, d = wo.shape
    return wo.reshape(kv, H // kv, D, d)


def _write_prefill_cache(cache, k, v, ctx):
    """k,v: [B,S,KV,D] -> cache layout [B,KV,S_max,D], zero-padded,
    written into ``cache``'s tensors (see the module docstring)."""
    S = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        dst = cache[name]
        dst[:, :, :S].copy_(t.transpose(1, 2))
        dst[:, :, S:].zero_()
    return cache


def _mla_latent(p, x, pos, ctx):
    """The latent ``ckv [B,T,L]`` and the shared rope key ``krope
    [B,T,1,R]`` of tokens ``x`` at positions ``pos``."""
    a = ctx.cfg.attention
    ckv = rms_norm(x @ p["wdkv"].to(x.dtype), p["kv_norm"], ctx.cfg.norm_eps)
    krope = apply_rope((x @ p["wkr"].to(x.dtype))[:, :, None, :],
                       pos[None, :, None], a.rope_theta)
    return ckv, krope


def _mla_query(p, x, pos, ctx):
    a, m = ctx.cfg.attention, ctx.cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, pos[None, :, None], a.rope_theta)


def mla_forward(p, x, ctx, *, cache=None):
    """DeepSeek-V2 Multi-head Latent Attention (full sequence).  With a
    cache, writes ``ckv`` and ``krope`` into it (zero past the sequence)."""
    a, m = ctx.cfg.attention, ctx.cfg.mla
    pos = ctx.positions
    q_nope, q_rope = _mla_query(p, x, pos, ctx)
    ckv, krope = _mla_latent(p, x, pos, ctx)
    # expand: per-head K = [k_nope | k_rope (broadcast)], V from the latent
    k_nope = torch.einsum("btl,lhn->bthn", ckv, p["wuk"].to(x.dtype))
    v = torch.einsum("btl,lhv->bthv", ckv, p["wuv"].to(x.dtype))
    k = torch.cat([k_nope, krope.expand(*k_nope.shape[:3],
                                        m.qk_rope_head_dim)], dim=-1)
    qh = torch.cat([q_nope, q_rope], dim=-1)
    # MHA layout: KV = H, G = 1; v's head dim (128) differs from qk's (192)
    out = sdpa(qh[:, :, :, None, :], k, v, pos_q=pos, causal=True,
               chunk=a.chunk_size, flash=ctx.flash)[:, :, :, 0, :]
    out = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(x.dtype))
    if cache is not None:
        S = x.shape[1]
        for name, t in (("ckv", ckv), ("krope", krope[:, :, 0, :])):
            cache[name][:, :S].copy_(t)
            cache[name][:, S:].zero_()
    return out, cache


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------

def attn_decode(p, x, cache, index, ctx):
    """x: [B,1,d]; cache: {k,v: [B,KV,S,D]}; index: int position.  Writes
    the token's k, v into ``cache`` in place and returns it."""
    a = ctx.cfg.attention
    index = int(index)
    q, k, v = _project(p, x, a)
    pos = torch.full((1,), index, device=x.device)
    q = apply_rope(q, pos[None, :, None], a.rope_theta)
    k = apply_rope(k, pos[None, :, None], a.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, :, index].copy_(k[:, 0])
    cv[:, :, index].copy_(v[:, 0])
    q = _group(q, a.n_kv_heads)  # [B,1,KV,G,D]
    s = torch.einsum("bskgd,bktd->bkgst", q.float(),
                     ck.to(q.dtype).float()) / math.sqrt(a.head_dim)
    mask = torch.arange(ck.shape[2], device=x.device) <= index
    s = torch.where(mask, s, NEG)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bktd->bskgd", prob.to(q.dtype).float(),
                       cv.to(q.dtype).float()).to(x.dtype)
    out = torch.einsum("bskgd,kgde->bse", out,
                       _group_w(p["wo"], a.n_kv_heads).to(x.dtype))
    return out, cache


def mla_decode(p, x, cache, index, ctx):
    """Weight-absorbed MLA decode, attending in the compressed latent
    space.  Writes the token's ``ckv`` and ``krope`` into ``cache`` in
    place and returns it."""
    m = ctx.cfg.mla
    index = int(index)
    pos = torch.full((1,), index, device=x.device)
    q_nope, q_rope = _mla_query(p, x, pos, ctx)
    ckv_t, kr_t = _mla_latent(p, x, pos, ctx)
    ckv, krope = cache["ckv"], cache["krope"]
    ckv[:, index].copy_(ckv_t[:, 0])
    krope[:, index].copy_(kr_t[:, 0, 0])
    # absorb W_uk into q; attend over the latent cache (f32 scores)
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope, p["wuk"].to(x.dtype))
    ckv_x = ckv.to(x.dtype)
    s = (torch.einsum("bshl,btl->bhst", q_lat.float(), ckv_x.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(),
                        krope.to(x.dtype).float()))
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    mask = torch.arange(ckv.shape[1], device=x.device) <= index
    s = torch.where(mask, s, NEG)
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btl->bshl", prob, ckv_x)
    out = torch.einsum("bshl,lhv->bshv", o_lat, p["wuv"].to(x.dtype))
    out = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(x.dtype))
    return out, cache


# ---------------------------------------------------------------------------
# Cache initializers
# ---------------------------------------------------------------------------

def init_attn_cache(cfg, batch, seq, dtype, device=None):
    a = cfg.attention
    shp = (batch, a.n_kv_heads, seq, a.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def init_mla_cache(cfg, batch, seq, dtype, device=None):
    m = cfg.mla
    return {"ckv": torch.zeros((batch, seq, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, seq, m.qk_rope_head_dim),
                                 dtype=dtype, device=device)}
