"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE 16e top-2. [arXiv:2403.19887]

Repeating unit of 8 layers: attention at position 4, Mamba elsewhere; MoE on
odd positions (every other layer), dense FFN on even — matching the
published period-8 Jamba block. 4 repeats = 32 layers, 4 attention layers.
"""
from repro_torch.configs.base import (AttentionConfig, LayerSpec,
                                      MambaConfig, MoEConfig, ModelConfig)

_UNIT = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    vocab_size=65536,
    d_ff=14336,
    mlp_kind="swiglu",
    unit=_UNIT,
    n_repeats=4,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    param_dtype="bfloat16",
    loss_chunk=512,
    sub_quadratic=True,  # hybrid: Mamba state + only 4 attn layers -> long_500k runs
)
