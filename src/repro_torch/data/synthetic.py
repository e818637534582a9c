"""Deterministic, seekable synthetic LM data (reference:
``repro/data/synthetic.py``).

Batches are a pure function of ``(seed, step)``: numpy's Philox stream
keyed by the seed with the step as its counter, the reference's own
generator, so each batch equals the reference's bit for bit and a job
restarted from a checkpoint at step k reads the same tokens.
``host_slice`` restricts the batch to one host's rows of the global
batch (the global batch is drawn whole, then sliced).  Batches are numpy
``int32`` arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    host_slice: Optional[Tuple[int, int]] = None  # (start_row, rows)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(key=self.seed,
                                                    counter=step))

    def __call__(self, step: int):
        if self.cfg.input_mode != "tokens" or self.cfg.vision is not None:
            raise NotImplementedError(
                "embedding inputs and vision embeddings are not ported yet: "
                "ROADMAP queue A, vision cross-attention and the audio stub")
        rng = self._rng(step)
        b0, rows = self.host_slice or (0, self.batch)
        # the whole global batch is drawn, then this host's rows are kept
        toks = rng.integers(0, self.cfg.vocab_size,
                            size=(self.batch, self.seq + 1), dtype=np.int32)
        # learnable structure: periodic patterns + noise
        period = 1 + (np.arange(self.batch) % 7)
        base = ((np.arange(self.seq + 1)[None, :] // period[:, None])
                % self.cfg.vocab_size)
        mask = rng.random((self.batch, self.seq + 1)) < 0.85
        toks = np.where(mask, base.astype(np.int32), toks)
        toks = toks[b0:b0 + rows]
        return {"labels": toks[:, 1:].copy(), "tokens": toks[:, :-1].copy()}
