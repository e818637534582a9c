"""dbrx-132b — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import (AttentionConfig, LayerSpec,
                                      MoEConfig, ModelConfig)

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    d_model=6144,
    vocab_size=100352,
    d_ff=10752,
    mlp_kind="swiglu",
    unit=(LayerSpec("attn", "moe"),),
    n_repeats=40,
    attention=AttentionConfig(n_heads=48, n_kv_heads=8, head_dim=128),
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    param_dtype="bfloat16",
    loss_chunk=512,
)
