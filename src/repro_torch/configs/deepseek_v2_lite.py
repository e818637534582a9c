"""deepseek-v2-lite-16b — MLA + fine-grained MoE. [arXiv:2405.04434]

As the reference's config and the published model card: 64 routed + 2
shared experts, top-6, MLA kv_lora_rank=512, first layer dense.
"""
from repro_torch.configs.base import (AttentionConfig, LayerSpec,
                                      MLAConfig, MoEConfig, ModelConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    d_model=2048,
    vocab_size=102400,
    d_ff=10944,  # dense first-layer FFN width (model card)
    mlp_kind="swiglu",
    prefix=(LayerSpec("mla", "dense"),),
    unit=(LayerSpec("mla", "moe"),),
    n_repeats=26,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=192),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared=2, d_ff_shared=1408),
    param_dtype="float32",
    loss_chunk=512,
)
