"""Model assembly: layer dispatch, the loop over repeats, prefill and
decode (reference: ``repro/models/model.py``).

Params are plain dicts shaped like the reference's tree: ``embed.emb``,
``prefix`` (a list of layers), ``unit`` (a tuple with one dict per unit
position, every leaf stacked on a leading ``[n_repeats]`` axis),
``final_norm`` and ``lm_head``.  ``convert.params_from_reference`` turns
the reference's tree into this one by copying leaves.  The reference
scans the repeat axis with ``lax.scan``; here a Python loop indexes it.

Ported: the ``attn`` (GQA), ``mla`` (latent attention), ``mamba`` (S6)
and ``rwkv`` (RWKV-6 token-mix) mixers, the ``dense``, ``moe`` and
``rwkv_cm`` (channel-mix) FFNs, so the dense zoo, dbrx-132b,
deepseek-v2-lite-16b, jamba-v0.1-52b and rwkv6-3b run; any other kind
(``xattn``, the audio stub's embeddings) raises ``NotImplementedError``.
``forward`` sums the MoE layers' aux losses over the prefix and the unit.
The prefill keeps the reference's default ``Ctx`` (MoE capacity
dropping); the decode step sets ``dropless``.

Training: ``loss_fn`` is the reference's mean next-token cross-entropy
(chunked over the sequence when ``cfg.loss_chunk`` divides it) plus the
MoE aux.  ``Ctx.remat`` recomputes each repeat of the unit in the
backward, as the reference's ``jax.checkpoint`` of its scan body does:
``"full"`` keeps only a repeat's input, ``"dots"`` also keeps its
matrix products' outputs.  Recomputation repeats the forward's
operations on the same inputs, so all three modes give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint as checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (dense_init, dt, embed_init, rms_norm,
                                       stack_init)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Context threaded through every layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    """The reference's ``Ctx`` without the fields that only steer XLA or
    sharding (``unroll``, ``constrain_fn``, ``moe_sm``) and without
    ``vision_embeds`` (cross-attention is not ported)."""

    cfg: ModelConfig
    positions: Any = None            # [S] int64 absolute positions
    kv_repeat: int = 1               # kv-head duplication factor (TP)
    remat: str = "none"              # none | dots | full (see ``forward``)
    # MoE dropless mode (decode/serving): capacity = all slots, no token
    # drops; ``make_decode_step`` sets it, the prefill keeps capacity
    # dropping, as in the reference
    dropless: bool = False
    # Use the flash-attention kernel (kernel F) for full-sequence
    # self-attention (forward-only paths: prefill; see kernels/flash).
    flash: bool = False


def _not_ported(kind: str):
    return NotImplementedError(
        f"{kind} is not ported yet: ROADMAP queue A, the model zoo")


# ---------------------------------------------------------------------------
# Per-layer init / apply / decode dispatch
# ---------------------------------------------------------------------------

def _init_mixer(gen, cfg, spec: LayerSpec, dtype):
    if spec.mixer == "attn":
        return attn_mod.init_attn(gen, cfg, dtype)
    if spec.mixer == "mla":
        return attn_mod.init_mla(gen, cfg, dtype)
    if spec.mixer == "mamba":
        return mamba_mod.init_mamba(gen, cfg, dtype)
    if spec.mixer == "rwkv":
        return rwkv_mod.init_rwkv_tm(gen, cfg, dtype)
    if spec.mixer == "none":
        return {}
    raise _not_ported(f"the {spec.mixer!r} mixer")


def _init_ffn(gen, cfg, spec: LayerSpec, dtype):
    if spec.ffn == "dense":
        return mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype)
    if spec.ffn == "moe":
        return moe_mod.init_moe(gen, cfg, dtype)
    if spec.ffn == "rwkv_cm":
        return rwkv_mod.init_rwkv_cm(gen, cfg, dtype)
    raise _not_ported(f"the {spec.ffn!r} FFN")


def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, dtype):
    dev = gen.device
    p = {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
         "mix": _init_mixer(gen, cfg, spec, dtype)}
    if spec.ffn != "none":
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        p["ffn"] = _init_ffn(gen, cfg, spec, dtype)
    return p


def _apply_mixer(spec, p, x, ctx, cache=None):
    if spec.mixer == "attn":
        return attn_mod.attn_forward(p, x, ctx, cache=cache)
    if spec.mixer == "mla":
        return attn_mod.mla_forward(p, x, ctx, cache=cache)
    if spec.mixer == "mamba":
        return mamba_mod.mamba_forward(p, x, ctx, cache=cache)
    if spec.mixer == "rwkv":
        return rwkv_mod.rwkv_tm_forward(p, x, ctx, cache=cache)
    if spec.mixer == "none":
        return x, None
    raise _not_ported(f"the {spec.mixer!r} mixer")


def _decode_mixer(spec, p, x, cache, index, ctx):
    if spec.mixer == "attn":
        return attn_mod.attn_decode(p, x, cache, index, ctx)
    if spec.mixer == "mla":
        return attn_mod.mla_decode(p, x, cache, index, ctx)
    if spec.mixer == "mamba":
        return mamba_mod.mamba_decode(p, x, cache, index, ctx)
    if spec.mixer == "rwkv":
        return rwkv_mod.rwkv_tm_forward(p, x, ctx, cache=cache)
    if spec.mixer == "none":
        return x, None
    raise _not_ported(f"the {spec.mixer!r} mixer")


def _apply_ffn(spec, p, x, ctx, cache=None):
    """Returns (out, aux_loss, new_cache)."""
    if spec.ffn == "dense":
        return mlp_mod.mlp_forward(p, x, ctx.cfg.mlp_kind, ctx), 0.0, None
    if spec.ffn == "moe":
        out, aux = moe_mod.moe_forward(p, x, ctx.cfg, ctx)
        return out, aux, None
    if spec.ffn == "rwkv_cm":
        out, c = rwkv_mod.rwkv_cm_forward(p, x, ctx, cache=cache)
        return out, 0.0, c
    if spec.ffn == "none":
        return torch.zeros_like(x), 0.0, None
    raise _not_ported(f"the {spec.ffn!r} FFN")


def apply_layer(spec, p, x, ctx, cache=None):
    """Pre-norm residual layer. Returns (x, aux, new_cache)."""
    eps = ctx.cfg.norm_eps
    h, mc = _apply_mixer(spec, p["mix"], rms_norm(x, p["norm1"], eps), ctx, cache=cache)
    x = x + h
    aux = 0.0
    fc = None
    if spec.ffn != "none":
        h, aux, fc = _apply_ffn(spec, p["ffn"], rms_norm(x, p["norm2"], eps), ctx, cache=cache)
        x = x + h
    return x, aux, _merge_cache(mc, fc)


def apply_layer_decode(spec, p, x, cache, index, ctx):
    eps = ctx.cfg.norm_eps
    h, mc = _decode_mixer(spec, p["mix"], rms_norm(x, p["norm1"], eps), cache, index, ctx)
    x = x + h
    fc = None
    if spec.ffn != "none":
        h, _, fc = _apply_ffn(spec, p["ffn"], rms_norm(x, p["norm2"], eps), ctx, cache=cache)
        x = x + h
    return x, _merge_cache(mc, fc)


def _merge_cache(mc, fc):
    if mc is None and fc is None:
        return None
    out = {}
    if mc:
        out.update(mc)
    if fc:
        out.update(fc)
    return out


def _at(tree, r: int):
    """Repeat ``r`` of a stacked unit tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def _generator(key, device: torch.device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(f"the generator is on {key.device}, the params "
                             f"would be on {device}")
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def init_params(key, cfg: ModelConfig, device=None) -> Dict:
    """Random params drawn from ``key`` (a ``torch.Generator`` or an int
    seed) on ``device`` (``None``: the card)."""
    cfg.validate()
    dev = resolve_device(device)
    gen = _generator(key, dev)
    dtype = dt(cfg.param_dtype)
    params: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        params["embed"] = {"emb": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)}
    else:
        raise _not_ported(f"input_mode {cfg.input_mode!r}")
    params["prefix"] = [init_layer(gen, cfg, s, dtype) for s in cfg.prefix]
    params["unit"] = tuple(
        stack_init(gen, cfg.n_repeats,
                   lambda g, spec=spec: init_layer(g, cfg, spec, dtype))
        for spec in cfg.unit)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return params


# ---------------------------------------------------------------------------
# Forward: backbone -> final-normed activations
# ---------------------------------------------------------------------------

def _embed(params, cfg, batch, ctx):
    if cfg.input_mode != "tokens":
        raise _not_ported(f"input_mode {cfg.input_mode!r}")
    x = params["embed"]["emb"][batch["tokens"].long()]
    return x.to(dt(cfg.compute_dtype))


def _with_positions(ctx, cfg, batch):
    ctx = ctx or Ctx(cfg=cfg)
    if ctx.positions is None:
        S = batch["tokens"].shape[1]
        ctx = dataclasses.replace(
            ctx, positions=torch.arange(S, device=batch["tokens"].device))
    return ctx


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matrix products' outputs (the
    reference's ``checkpoint_dots``), recompute everything else."""
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _unbind(tree, n: int):
    """The ``n`` repeats of a stacked unit tree: one tree of views a
    repeat (its backward stacks the repeats' gradients once)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in parts.items()} for r in range(n)]
    return tree.unbind(0)


def _unit_repeat(cfg, ctx, layers, x, aux):
    for spec, p in zip(cfg.unit, layers):
        x, a, _ = apply_layer(spec, p, x, ctx)
        aux = aux + a
    return x, aux


def forward(params, cfg: ModelConfig, batch, ctx: Optional[Ctx] = None):
    """Returns (final-normed activations [B,S,d], moe_aux scalar).

    With ``ctx.remat`` other than ``"none"``, each repeat of the unit runs
    under ``torch.utils.checkpoint`` (non-reentrant): ``"full"`` saves
    nothing inside it, ``"dots"`` saves the matrix products' outputs."""
    ctx = _with_positions(ctx, cfg, batch)
    if ctx.remat not in ("none", "dots", "full"):
        raise ValueError(f"remat {ctx.remat!r}: none, dots or full")
    x = _embed(params, cfg, batch, ctx)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for spec, p in zip(cfg.prefix, params["prefix"]):
        x, a, _ = apply_layer(spec, p, x, ctx)
        aux = aux + a
    kw = {}
    if ctx.remat == "dots":
        kw["context_fn"] = lambda: (
            checkpoint.create_selective_checkpoint_contexts(_save_dots))
    for layers in zip(*(_unbind(u, cfg.n_repeats) for u in params["unit"])):
        if ctx.remat == "none":
            x, aux = _unit_repeat(cfg, ctx, layers, x, aux)
        else:
            x, aux = checkpoint.checkpoint(_unit_repeat, cfg, ctx, layers, x,
                                           aux, use_reentrant=False, **kw)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def _ce(logits, labels):
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def loss_fn(params, cfg: ModelConfig, batch, ctx: Optional[Ctx] = None):
    """Mean next-token CE (+ MoE aux): ``(loss, {"ce", "moe_aux"})``.

    Chunked over the sequence when ``cfg.loss_chunk`` divides S and is
    smaller: each chunk's logits ``x_i @ w_head`` in the compute dtype,
    its CE in f32, the chunks' sums added in f32 and divided by B * S, as
    in the reference.  The head is cast to the compute dtype once, not
    once a chunk (the same values)."""
    x, aux = forward(params, cfg, batch, ctx)
    labels = batch["labels"]
    w_head = params["lm_head"].to(x.dtype)
    chunk = cfg.loss_chunk
    B, S = x.shape[0], x.shape[1]
    if chunk and S % chunk == 0 and S > chunk:
        tot = torch.zeros((), dtype=F32, device=x.device)
        for lo in range(0, S, chunk):
            logits = x[:, lo:lo + chunk] @ w_head
            tot = tot + _ce(logits, labels[:, lo:lo + chunk]).sum()
        ce = tot / (B * S)
    else:
        ce = _ce(x @ w_head, labels).mean()
    coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    return ce + coef * aux, {"ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# KV-cache: init / prefill / decode
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg, spec: LayerSpec, batch, seq, dtype, device):
    if spec.mixer == "attn":
        c = attn_mod.init_attn_cache(cfg, batch, seq, dtype, device)
    elif spec.mixer == "mla":
        c = attn_mod.init_mla_cache(cfg, batch, seq, dtype, device)
    elif spec.mixer == "mamba":
        c = mamba_mod.init_mamba_cache(cfg, batch, dtype, device)
    elif spec.mixer == "rwkv":
        c = {k: v for k, v in rwkv_mod.init_rwkv_cache(
            cfg, batch, dtype, device).items() if k in ("shift_tm", "wkv")}
    elif spec.mixer == "none":
        c = {}
    else:
        raise _not_ported(f"the {spec.mixer!r} mixer's cache")
    if spec.ffn == "rwkv_cm":
        c["shift_cm"] = torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16,
               device=None):
    """Zero caches on ``device`` (``None``: the card); unit caches stacked
    ``[n_repeats, ...]`` as in the reference."""
    dev = resolve_device(device)
    prefix = [_init_layer_cache(cfg, s, batch, seq, dtype, dev)
              for s in cfg.prefix]
    unit = []
    for spec in cfg.unit:
        one = _init_layer_cache(cfg, spec, batch, seq, dtype, dev)
        unit.append({k: torch.zeros((cfg.n_repeats, *a.shape), dtype=a.dtype,
                                    device=dev) for k, a in one.items()})
    return {"prefix": prefix, "unit": tuple(unit)}


# the recurrent layers' states, which the prefill reads as its initial
# ones (Mamba's conv window and SSM state, RWKV's shifts and wkv state)
STATE_KEYS = ("conv", "ssm", "shift_tm", "wkv", "shift_cm")


def _fresh(cache):
    """New tensors shaped like ``cache``: the recurrent states zeroed (the
    prefill starts from them), the attention caches empty (the prefill
    writes every position it reads)."""
    def new(k, t):
        return torch.zeros_like(t) if k in STATE_KEYS else torch.empty_like(t)

    return {"prefix": [{k: new(k, t) for k, t in c.items()}
                       for c in cache["prefix"]],
            "unit": tuple({k: new(k, t) for k, t in c.items()}
                          for c in cache["unit"])}


def make_prefill(cfg: ModelConfig):
    """prefill(params, batch, cache, ctx) -> (last_logits, cache).

    The returned cache is new; the one passed in only gives its shapes
    and dtype.  The reference reads the recurrent layers' states of the
    cache it is given as their initial ones and is always given zeroed
    ones; here they start from zero whatever the given cache holds."""
    def prefill(params, batch, cache, ctx: Optional[Ctx] = None):
        ctx = _with_positions(ctx, cfg, batch)
        x = _embed(params, cfg, batch, ctx)
        new = _fresh(cache)
        for spec, p, c in zip(cfg.prefix, params["prefix"], new["prefix"]):
            x, _, _ = apply_layer(spec, p, x, ctx, cache=c)
        for r in range(cfg.n_repeats):
            for i, spec in enumerate(cfg.unit):
                x, _, _ = apply_layer(spec, _at(params["unit"][i], r), x, ctx,
                                      cache=_at(new["unit"][i], r))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = x[:, -1:, :] @ params["lm_head"].to(x.dtype)
        return logits, new
    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, token, cache, index, ctx) -> (logits, cache).

    ``cache`` is updated in place and returned (the reference returns an
    updated copy)."""
    def decode(params, inp, cache, index, ctx: Optional[Ctx] = None):
        ctx = ctx or Ctx(cfg=cfg)
        index = int(index)
        ctx = dataclasses.replace(
            ctx, positions=torch.full((1,), index, device=inp.device),
            dropless=True)
        if cfg.input_mode != "tokens":
            raise _not_ported(f"input_mode {cfg.input_mode!r}")
        x = params["embed"]["emb"][inp.long()].to(dt(cfg.compute_dtype))
        for spec, p, c in zip(cfg.prefix, params["prefix"], cache["prefix"]):
            x, _ = apply_layer_decode(spec, p, x, c, index, ctx)
        for r in range(cfg.n_repeats):
            for i, spec in enumerate(cfg.unit):
                x, _ = apply_layer_decode(spec, _at(params["unit"][i], r), x,
                                          _at(cache["unit"][i], r), index, ctx)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = x @ params["lm_head"].to(x.dtype)
        return logits, cache
    return decode


# ---------------------------------------------------------------------------
# Convenience wrapper
# ---------------------------------------------------------------------------

class Model:
    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        self.cfg = cfg

    def init(self, key, device=None):
        return init_params(key, self.cfg, device)

    def loss(self, params, batch, ctx=None):
        return loss_fn(params, self.cfg, batch, ctx)

    def forward(self, params, batch, ctx=None):
        return forward(params, self.cfg, batch, ctx)

    def prefill(self):
        return make_prefill(self.cfg)

    def decode_step(self):
        return make_decode_step(self.cfg)

    def init_cache(self, batch, seq, dtype=torch.bfloat16, device=None):
        return init_cache(self.cfg, batch, seq, dtype, device)
