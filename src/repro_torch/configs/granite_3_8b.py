"""granite-3-8b — dense GQA transformer. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    d_model=4096,
    vocab_size=49155,
    d_ff=12800,
    mlp_kind="swiglu",
    unit=(LayerSpec("attn", "dense"),),
    n_repeats=40,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128),
    param_dtype="float32",
    loss_chunk=512,
)
