"""Top-k mixture-of-experts with sort-based (capacity) dispatch
(reference: ``repro/models/moe.py``).

Tokens are routed by an f32 router, sorted stably by expert id, ranked
within their expert by a cumulative count and written into an
``[E, C, d]`` buffer; the gated expert FFN runs as batched products with
the expert axis first; each token's k slots come back weighted by their
gates.  ``moe_forward`` returns ``(out, aux)``, the aux being the
Switch-form load-balance loss.  ``moe_forward_ref`` is the reference's own
plain version: every expert on every token, O(N * E).

Where the port takes other means to the same result:

  * the router product is taken in float64 and rounded to f32 once, so a
    TF32 setting in the caller's process cannot reach it and the card and
    the CPU route alike wherever a margin is wider than an f32 rounding;
  * the top-k is a stable descending sort: ties keep the lower expert
    index, as ``jax.lax.top_k`` does (``torch.topk`` promises no order);
  * no float atomics: the dispatch writes each kept slot once (an indexed
    copy; dropped slots go to one discard row), and the combine gathers a
    token's k slots into ``[N, k, d]`` and adds them in ascending expert
    order, the order they take in the sorted dispatch, in the expert
    output's dtype.  Two runs on one device are equal bit for bit.

``moe_forward_shardmap`` (expert parallelism on a model sharding plan) is
not ported: ROADMAP queue A, sharding the model across cards.

``forced_routes`` is a hook for checks only: within it, each ``route``
call takes its ``idx`` and ``gate`` from a given sequence instead of the
router (its ``probs``, and so the aux, stay the router's), so two runs
whose routers part on near ties can be held on the same experts.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.mlp import mlp_forward

F32 = torch.float32


def init_moe(gen, cfg, dtype):
    """The router in f32, expert tensors ``[E, d_in, d_out]`` in ``dtype``
    (drawn an expert at a time), and ``shared`` when ``n_shared`` is set."""
    m, d = cfg.moe, cfg.d_model

    def e_init(d_in, d_out):
        out = torch.empty((m.n_experts, d_in, d_out), dtype=dtype,
                          device=gen.device)
        std = 1.0 / math.sqrt(d_in)
        for e in range(m.n_experts):
            out[e] = torch.randn((d_in, d_out), generator=gen,
                                 device=gen.device, dtype=F32) * std
        return out

    p = {
        "router": dense_init(gen, d, m.n_experts, F32),
        "w_in": e_init(d, m.d_ff_expert),
        "w_gate": e_init(d, m.d_ff_expert),
        "w_out": e_init(m.d_ff_expert, d),
    }
    if m.n_shared:
        f_sh = m.n_shared * m.d_ff_shared
        p["shared"] = {"w_in": dense_init(gen, d, f_sh, dtype),
                       "w_gate": dense_init(gen, d, f_sh, dtype),
                       "w_out": dense_init(gen, f_sh, d, dtype)}
    return p


_FORCED = None   # an iterator of (idx, gate) while ``forced_routes`` runs


@contextlib.contextmanager
def forced_routes(routes: Iterable[Tuple[torch.Tensor, torch.Tensor]]):
    """For checks only: within ``with``, the n-th ``route`` call returns
    the n-th ``(idx [N, k], gate [N, k])`` of ``routes`` (moved to the
    call's device) in place of its own; a call past the end, or a pair of
    another shape, raises."""
    global _FORCED
    if _FORCED is not None:
        raise RuntimeError("forced_routes does not nest")
    _FORCED = iter(routes)
    try:
        yield
    finally:
        _FORCED = None


def _forced(idx, gate):
    try:
        f_idx, f_gate = next(_FORCED)
    except StopIteration:
        raise RuntimeError("forced_routes: more route calls than routes")
    if f_idx.shape != idx.shape or f_gate.shape != gate.shape:
        raise ValueError(f"forced_routes: a route of {tuple(f_idx.shape)} "
                         f"for a call of {tuple(idx.shape)}")
    return f_idx.to(idx.device), f_gate.to(gate.device, gate.dtype)


def route(xt, router, k: int):
    """The router on tokens ``xt [N, d]``: ``probs [N, E]`` (f32), the
    renormalised ``gate [N, k]`` and ``idx [N, k]``, highest first."""
    logits = (xt.double() @ router.double()).to(F32)
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :k], order[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    if _FORCED is not None:
        idx, gate = _forced(idx, gate)
    return probs, gate, idx


def capacity(cfg, n_tokens: int, dropless: bool) -> int:
    """Slots an expert holds: every slot when ``dropless``, else the
    reference's ``max(ceil(N k / E * capacity_factor), 4)``."""
    m = cfg.moe
    if dropless:
        return n_tokens * m.top_k
    return max(int(math.ceil(n_tokens * m.top_k / m.n_experts
                             * m.capacity_factor)), 4)


def moe_forward(p, x, cfg, ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> (out [B,S,d], aux_loss scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    N, k, E = B * S, m.top_k, m.n_experts
    dev = x.device
    xt = x.reshape(N, d)
    probs, gate, idx = route(xt, p["router"], k)

    # ---- load-balance aux loss (fraction routed * mean prob, Switch form)
    flat_e = idx.reshape(N * k)
    counts = torch.bincount(flat_e, minlength=E)
    f = counts.to(F32) / N             # fraction of tokens per expert (x k)
    aux = E * torch.sum(f * probs.mean(0)) / k

    # ---- sort-based dispatch: kept slot (e, rank) -> row e * C + rank
    C = capacity(cfg, N, ctx is not None and getattr(ctx, "dropless", False))
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * k, device=dev) - starts[sorted_e]
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)  # E * C: discard
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=dev)
    buf[dest] = xt[order // k]
    buf = buf[:E * C].view(E, C, d)

    # ---- expert FFN (gated), expert axis leading
    h = torch.bmm(buf, p["w_in"].to(buf.dtype))
    g = torch.bmm(buf, p["w_gate"].to(buf.dtype))
    del buf
    h = F.silu(g).mul_(h)
    del g
    eo = torch.bmm(h, p["w_out"].to(h.dtype)).view(E * C, d)
    del h

    # ---- combine: each token's k slots in ascending expert order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N * k, device=dev)
    _, by_e = idx.sort(dim=1)
    slot = inv.view(N, k).gather(1, by_e).reshape(N * k)  # sorted position
    kept = keep[slot]
    rows = torch.where(kept, dest[slot], 0)
    w = (gate.gather(1, by_e).reshape(N * k).to(eo.dtype)
         * kept.to(eo.dtype))
    contrib = (eo[rows] * w[:, None]).view(N, k, d)
    out = contrib[:, 0].clone()
    for i in range(1, k):
        out += contrib[:, i]

    if m.n_shared:
        out = out + mlp_forward(p["shared"], xt, "swiglu", ctx)
    return out.reshape(B, S, d), aux


def moe_forward_ref(p, x, cfg):
    """O(N*E) plain version (every expert on every token) for checks."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    _, gate, idx = route(xt, p["router"], m.top_k)
    wd = xt.dtype
    h = torch.einsum("nd,edf->enf", xt, p["w_in"].to(wd))
    g = torch.einsum("nd,edf->enf", xt, p["w_gate"].to(wd))
    eo = torch.einsum("enf,efd->end", F.silu(g) * h, p["w_out"].to(wd))
    w = torch.zeros((xt.shape[0], m.n_experts), dtype=F32, device=x.device)
    w.scatter_(1, idx, gate)           # [N, E]: a token's gate at its experts
    out = torch.einsum("end,ne->nd", eo.float(), w).to(x.dtype)
    if m.n_shared:
        out = out + mlp_forward(p["shared"], xt, "swiglu")
    return out.reshape(B, S, d)
