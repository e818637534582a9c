"""Batched serving engine: prefill once, decode tokens with a KV cache
(reference: ``repro/serve/engine.py``).

``make_serve_step`` is one new token against a seq_len cache.  The engine
adds sampling and a Python generation loop.  As in the reference, the
engine prefills with a default ``Ctx``, so it serves on the chunked
online-softmax route; the flash kernel is taken only by a caller of
``make_prefill`` whose ``Ctx`` sets ``flash``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import (Ctx, init_cache, make_decode_step,
                                      make_prefill)


def make_serve_step(cfg: ModelConfig, plan=None):
    """decode_step(params, inp, cache, index) -> (logits, cache)."""
    if plan is not None:
        raise NotImplementedError(
            "a model sharding plan (the reference's parallel/ Plan) is not "
            "ported yet: ROADMAP queue A, sharding the model across cards")
    decode = make_decode_step(cfg)

    def serve_step(params, inp, cache, index):
        return decode(params, inp, cache, index, Ctx(cfg=cfg))

    return serve_step


def _devices(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _devices(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _devices(v)
    else:
        yield tree.device


class ServeEngine:
    """``device=None`` means the card; the params must already be there."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int, batch: int,
                 cache_dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        for d in _devices(params):
            if d.type != self.device.type:
                raise ValueError(f"ServeEngine: a param is on {d}, the "
                                 f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self.cache = init_cache(cfg, batch, max_seq, cache_dtype, self.device)
        self._prefill = make_prefill(cfg)
        self._decode = make_decode_step(cfg)

    def generate(self, prompt_tokens, n_steps: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """prompt_tokens: [B, L] ints. Returns [B, n_steps] int32 ids.

        Greedy (``argmax``) unless ``temperature > 0`` and a
        ``generator`` is given; then each token is drawn from
        softmax(logits / temperature) with that generator (the reference
        draws with a JAX key, so the two draw different tokens)."""
        tokens = prompt_tokens if torch.is_tensor(prompt_tokens) else \
            torch.as_tensor(np.asarray(prompt_tokens))
        tokens = tokens.to(self.device)
        B, L = tokens.shape
        if B != self.batch or L + n_steps > self.max_seq:
            raise ValueError(f"generate: {B} prompts of {L} + {n_steps} "
                             f"tokens do not fit batch {self.batch} and "
                             f"max_seq {self.max_seq}")
        logits, cache = self._prefill(self.params, {"tokens": tokens},
                                      self.cache)
        outs = []
        tok = self._sample(logits[:, -1, :], temperature, generator)
        for i in range(n_steps):
            outs.append(tok)
            logits, cache = self._decode(self.params, tok[:, None], cache,
                                         L + i)
            tok = self._sample(logits[:, -1, :], temperature, generator)
        self.cache = cache
        return torch.stack(outs, dim=1)

    @staticmethod
    def _sample(logits, temperature, generator):
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
