"""Mamba (S6) selective-state-space mixer, as used by Jamba (reference:
``repro/models/mamba.py``).

The prefill and the training forward run the scan over time as kernel L
(``kernels/scans/selective_scan.py``: the CUDA kernel on the card, its
plain torch loop on the CPU) with f32 state; decode keeps a (conv window,
SSM state) pair as its cache.  The conv runs in the compute dtype, the
scan in f32, as in the reference.

In place, unlike the reference: given a cache, ``mamba_forward`` reads
its ``conv`` window and ``ssm`` state as the initial ones and then writes
the new window and state into it (``copy_``) and returns it, as the
attention mixers do with their caches.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.scans.selective_scan import selective_scan
from repro_torch.models.layers import dense_init

F32 = torch.float32


def _dt_rank(d_model: int) -> int:
    return max(1, math.ceil(d_model / 16))


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as JAX computes it,
    ``max(x, 0) + log1p(exp(-|x|))``, in x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba(gen, cfg, dtype):
    m, d = cfg.mamba, cfg.d_model
    di = m.expand * d
    r = _dt_rank(d)
    dev = gen.device
    # S4D-real initialization for A
    a_init = torch.arange(1, m.d_state + 1, dtype=F32,
                          device=dev)[None, :].repeat(di, 1)
    p = {
        # separate x/z projections, as in the reference
        "in_proj_x": dense_init(gen, d, di, dtype),
        "in_proj_z": dense_init(gen, d, di, dtype),
        "conv_w": (torch.randn((m.d_conv, di), generator=gen, device=dev,
                               dtype=F32) / math.sqrt(m.d_conv)).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, r + 2 * m.d_state, dtype),
        # ~ N(0, 1/sqrt(r)), the reference's scale
        "dt_proj": dense_init(gen, r, di, dtype, scale=r ** -0.5 * r),
    }
    u = torch.rand((di,), generator=gen, device=dev, dtype=F32)
    p["dt_bias"] = torch.log(torch.expm1(torch.clamp_min(
        u * (0.1 - 1e-3) + 1e-3, 1e-4))).to(dtype)
    p["A_log"] = torch.log(a_init)
    p["D"] = torch.ones((di,), dtype=F32, device=dev)
    p["out_proj"] = dense_init(gen, di, d, dtype)
    return p


def _causal_conv(x, w, b, init_window=None):
    """x: [B,S,di]; w: [K,di]. Depthwise causal conv via K shifted adds,
    summed in the reference's order; returns (y, the last K-1 inputs)."""
    K = w.shape[0]
    if init_window is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = init_window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + S, :] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(K - 1):, :]


def mamba_forward(p, x, ctx, *, cache=None):
    """x: [B,S,d] -> (out, cache): the cache given, updated in place."""
    m = ctx.cfg.mamba
    d = ctx.cfg.d_model
    di = m.expand * d
    r = _dt_rank(d)
    xi = x @ p["in_proj_x"].to(x.dtype)
    z = x @ p["in_proj_z"].to(x.dtype)
    conv_init = None if cache is None else cache["conv"]
    xi, conv_win = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_init)
    xi = F.silu(xi)
    xdbl = xi @ p["x_proj"].to(x.dtype)
    dt_r, Bc, Cc = torch.split(xdbl, [r, m.d_state, m.d_state], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"].to(x.dtype)
                  + p["dt_bias"].to(x.dtype)).to(F32)  # [B,S,di]
    A = -torch.exp(p["A_log"])  # [di, ds] f32
    h0 = (torch.zeros((x.shape[0], di, m.d_state), dtype=F32,
                      device=x.device) if cache is None
          else cache["ssm"].to(F32))
    ys, h_last = selective_scan(xi, dt, Bc, Cc, A, h0)
    y = ys.to(x.dtype) + xi * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    if cache is not None:
        cache["conv"].copy_(conv_win)
        cache["ssm"].copy_(h_last)
    return out, cache


def mamba_decode(p, x, cache, index, ctx):
    """Single-token step; cache = {conv: [B,K-1,di], ssm: [B,di,ds]}."""
    return mamba_forward(p, x, ctx, cache=cache)


def init_mamba_cache(cfg, batch, dtype, device=None):
    m = cfg.mamba
    di = m.expand * cfg.d_model
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, m.d_state), dtype=F32,
                               device=device)}
