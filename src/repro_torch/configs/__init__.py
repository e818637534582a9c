"""Architecture config registry: ``get_config("<arch-id>")``.

The same ids as the reference's registry.  The dense GQA archs
(granite-3-8b, minitron-4b), the sparse-expert dbrx-132b (GQA + MoE),
deepseek-v2-lite-16b (MLA + MoE, a dense first layer), the hybrid
jamba-v0.1-52b (Mamba + GQA, MoE) and the attention-free rwkv6-3b have
every mixer and FFN ported; the others raise ``NotImplementedError``
naming the ROADMAP slice that brings them.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (AttentionConfig, LayerSpec, MLAConfig,
                                      MambaConfig, ModelConfig, MoEConfig,
                                      RWKVConfig, ShapeConfig, TrainConfig,
                                      VisionStubConfig, LM_SHAPES, reduced)

_MODULES: Dict[str, str] = {
    "granite-3-8b": "granite_3_8b",
    "minitron-4b": "minitron_4b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "dbrx-132b": "dbrx_132b",
    "jamba-v0.1-52b": "jamba_v0_1",
    "rwkv6-3b": "rwkv6_3b",
}

# arch id -> what it needs that the port lacks (ROADMAP queue A, "The rest
# of the model zoo")
_NOT_PORTED: Dict[str, str] = {
    "nemotron-4-340b": "sharding its 680 GB of bf16 params (parallel/)",
    "qwen1.5-110b": "sharding its 220 GB of bf16 params (parallel/)",
    "musicgen-medium": "the audio frontend stub (input_mode='embeddings')",
    "llama-3.2-vision-11b": "cross-attention (vision)",
}

ARCH_IDS = tuple(_MODULES) + tuple(_NOT_PORTED)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: {_NOT_PORTED[arch]} is not ported yet: ROADMAP queue "
            f"A, the model zoo")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


__all__ = [
    "ARCH_IDS", "get_config", "get_shape", "reduced",
    "ModelConfig", "ShapeConfig", "TrainConfig", "LayerSpec",
    "AttentionConfig", "MLAConfig", "MoEConfig", "MambaConfig", "RWKVConfig",
    "VisionStubConfig", "LM_SHAPES",
]
