"""RWKV-6 ("Finch") mixer: token-mix with data-dependent decay, and the
channel-mix (reference: ``repro/models/rwkv.py``).

State per layer: the token-shift vectors and the per-head ``[hd_k, hd_v]``
wkv matrix.  The wkv recurrence over time runs as kernel M
(``kernels/scans/wkv6.py``: the CUDA kernel on the card, its plain torch
loop on the CPU) with f32 state.

In place, unlike the reference: given a cache, ``rwkv_tm_forward`` reads
its ``shift_tm`` and ``wkv`` (``rwkv_cm_forward`` its ``shift_cm``) as the
initial ones, writes the new ones into it (``copy_``) and returns it.  A
layer's one cache dict holds all three; each function touches only its
own keys.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.scans.wkv6 import wkv6
from repro_torch.models.layers import dense_init, group_norm_heads

F32 = torch.float32
GN_EPS = 64e-5


def init_rwkv_tm(gen, cfg, dtype):
    d = cfg.d_model
    r = cfg.rwkv
    H, hd = d // r.head_dim, r.head_dim
    dev = gen.device
    return {
        "mu": torch.rand((5, d), generator=gen, device=dev,
                         dtype=F32).to(dtype),  # r,k,v,w,g
        "w0": torch.full((d,), -6.0, dtype=F32, device=dev),
        "w_A": dense_init(gen, d, r.decay_lora, dtype),
        "w_B": dense_init(gen, r.decay_lora, d, dtype, scale=0.1),
        "u": torch.randn((H, hd), generator=gen, device=dev,
                         dtype=F32) * 0.1,
        "wr": dense_init(gen, d, d, dtype).reshape(d, H, hd),
        "wk": dense_init(gen, d, d, dtype).reshape(d, H, hd),
        "wv": dense_init(gen, d, d, dtype).reshape(d, H, hd),
        "wg": dense_init(gen, d, d, dtype).reshape(d, H, hd),
        "gn_w": torch.ones((H, hd), dtype=F32, device=dev),
        "gn_b": torch.zeros((H, hd), dtype=F32, device=dev),
        "wo": dense_init(gen, d, d, dtype).reshape(H, hd, d),
    }


def init_rwkv_cm(gen, cfg, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": torch.rand((2, d), generator=gen, device=gen.device,
                         dtype=F32).to(dtype),  # k, r
        "wk": dense_init(gen, d, f, dtype),
        "wv": dense_init(gen, f, d, dtype),
        "wr": dense_init(gen, d, d, dtype),
    }


def _shift(x, prev):
    """Token shift: x[:, t] -> x[:, t-1]; prev: [B,d] previous last token."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _heads(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one product."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).unflatten(
        -1, tuple(w.shape[1:]))


def rwkv_tm_forward(p, x, ctx, *, cache=None):
    cfg = ctx.cfg
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    H = d // hd
    B, S, _ = x.shape
    prev = (torch.zeros((B, d), dtype=x.dtype, device=x.device)
            if cache is None else cache["shift_tm"])
    xs = _shift(x, prev)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_lerp(x, xs, mu[i]) for i in range(5))
    rr, kk, vv, gg = (_heads(t, p[n]) for t, n in
                      ((xr, "wr"), (xk, "wk"), (xv, "wv"), (xg, "wg")))
    # data-dependent decay (per key channel), f32 for stability
    lora = torch.tanh(xw @ p["w_A"].to(x.dtype)).to(F32) @ p["w_B"].to(F32)
    w = torch.exp(-torch.exp(p["w0"][None, None] + lora)).reshape(
        B, S, H, hd)  # in (0,1)
    S0 = (torch.zeros((B, H, hd, hd), dtype=F32, device=x.device)
          if cache is None else cache["wkv"].to(F32))
    y, S_last = wkv6(rr, kk, vv, w, p["u"], S0)  # [B,S,H,hd_v] f32
    y = group_norm_heads(y, p["gn_w"], p["gn_b"], GN_EPS).to(x.dtype)
    y = y * F.silu(gg)
    out = y.reshape(B, S, d) @ p["wo"].to(x.dtype).reshape(d, d)
    if cache is not None:
        cache["shift_tm"].copy_(x[:, -1, :])
        cache["wkv"].copy_(S_last)
    return out, cache


def rwkv_cm_forward(p, x, ctx, *, cache=None):
    prev = (torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype,
                        device=x.device)
            if cache is None else cache["shift_cm"])
    xs = _shift(x, prev)
    xk = _lerp(x, xs, p["mu"][0])
    xr = _lerp(x, xs, p["mu"][1])
    k = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
    out = torch.sigmoid(xr @ p["wr"].to(x.dtype)) * (k @ p["wv"].to(x.dtype))
    if cache is not None:
        cache["shift_cm"].copy_(x[:, -1, :])
    return out, cache


def init_rwkv_cache(cfg, batch, dtype, device=None):
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    H = d // hd
    return {"shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, H, hd, hd), dtype=F32, device=device),
            "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device)}
