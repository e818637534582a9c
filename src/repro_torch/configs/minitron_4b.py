"""minitron-4b — pruned nemotron, squared-ReLU. [arXiv:2407.14679]"""
from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    d_model=3072,
    vocab_size=256000,
    d_ff=9216,
    mlp_kind="sq_relu",
    unit=(LayerSpec("attn", "dense"),),
    n_repeats=32,
    attention=AttentionConfig(n_heads=24, n_kv_heads=8, head_dim=128),
    param_dtype="float32",
    loss_chunk=512,
)
