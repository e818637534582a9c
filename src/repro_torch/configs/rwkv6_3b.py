"""rwkv6-3b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    d_model=2560,
    vocab_size=65536,
    d_ff=8960,
    mlp_kind="gelu",  # unused by rwkv_cm; kept for completeness
    unit=(LayerSpec("rwkv", "rwkv_cm"),),
    n_repeats=32,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    param_dtype="float32",
    sub_quadratic=True,  # attn-free: O(1) state -> long_500k runs
)
