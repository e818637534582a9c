"""Config dataclasses of the model zoo, copied from the reference's
``repro.configs.base`` (plain data and arithmetic; nothing here imports
the reference).

Every architecture is a ``ModelConfig``: a repeating ``unit`` of
``LayerSpec``s (mixer + ffn kind per position) applied ``n_repeats``
times, with optional non-repeated ``prefix`` layers.  Unit params are
stacked on a leading ``[n_repeats]`` axis, as in the reference; the port
walks that axis with a Python loop where the reference scans it.  The
dense GQA family, MoE and MLA run in the port so far
(``configs.get_config`` raises for the rest); the other sub-configs are
kept as plain data so ``reduced`` keeps its meaning.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer taxonomy
# ---------------------------------------------------------------------------

MIXERS = ("attn", "mla", "mamba", "rwkv", "xattn", "none")
FFNS = ("dense", "moe", "rwkv_cm", "none")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside the repeating unit."""

    mixer: str  # one of MIXERS
    ffn: str    # one of FFNS

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.ffn in FFNS, self.ffn


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # Attention is computed with an online-softmax KV-chunked scan whenever
    # seq_len exceeds this (memory-roofline optimization); dense otherwise.
    chunk_size: int = 1024


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # rank of the data-dependent decay LoRA


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """Precomputed-patch-embedding frontend stub (assignment: stub only)."""

    n_tokens: int = 1601
    dim: int = 7680


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    vocab_size: int
    d_ff: int
    mlp_kind: str  # swiglu | sq_relu | gelu
    unit: Tuple[LayerSpec, ...]
    n_repeats: int
    prefix: Tuple[LayerSpec, ...] = ()
    attention: Optional[AttentionConfig] = None
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    vision: Optional[VisionStubConfig] = None
    # "tokens": int32 token ids in; "embeddings": precomputed frame
    # embeddings in (audio stub per assignment).
    input_mode: str = "tokens"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # cross-entropy computed in seq chunks of this size when set (avoids
    # materializing [B,S,V] logits — memory-roofline optimization)
    loss_chunk: int = 0
    # full attention? (pure full-attention archs skip long_500k per spec)
    sub_quadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return len(self.prefix) + len(self.unit) * self.n_repeats

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND MODEL_FLOPS)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed top-k)."""
        return _param_count(self, active_only=True)

    def validate(self) -> None:
        for spec in self.prefix + self.unit:
            if spec.mixer in ("attn", "xattn"):
                assert self.attention is not None
            if spec.mixer == "mla":
                assert self.mla is not None and self.attention is not None
            if spec.mixer == "mamba":
                assert self.mamba is not None
            if spec.mixer == "rwkv":
                assert self.rwkv is not None
            if spec.ffn == "moe":
                assert self.moe is not None
        if any(s.mixer == "xattn" for s in self.unit + self.prefix):
            assert self.vision is not None


# ---------------------------------------------------------------------------
# Shapes (assignment-fixed input shape sets)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


# ---------------------------------------------------------------------------
# Training config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # memory knobs
    remat: str = "full"  # none | dots | full
    microbatches: int = 1
    moment_dtype: str = "float32"  # bf16 for the >=100B archs in dry-run
    # distributed-optimization tricks
    compress_grads: bool = False  # int8 error-feedback reduce
    # power-stabilization hook (the paper's technique, in-graph)
    ballast: bool = False
    ballast_gflops: float = 0.0


# ---------------------------------------------------------------------------
# Analytic parameter counting
# ---------------------------------------------------------------------------

def _mixer_params(cfg: ModelConfig, spec: LayerSpec) -> int:
    d = cfg.d_model
    if spec.mixer == "attn":
        a = cfg.attention
        q = d * a.n_heads * a.head_dim
        kv = 2 * d * a.n_kv_heads * a.head_dim
        o = a.n_heads * a.head_dim * d
        b = (a.n_heads + 2 * a.n_kv_heads) * a.head_dim if a.qkv_bias else 0
        return q + kv + o + b
    if spec.mixer == "xattn":
        a, v = cfg.attention, cfg.vision
        q = d * a.n_heads * a.head_dim
        kv = 2 * v.dim * a.n_kv_heads * a.head_dim
        o = a.n_heads * a.head_dim * d
        return q + kv + o + 2  # + gates
    if spec.mixer == "mla":
        a, m = cfg.attention, cfg.mla
        q = d * a.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        dkv = d * (m.kv_lora_rank + m.qk_rope_head_dim)
        uk = m.kv_lora_rank * a.n_heads * m.qk_nope_head_dim
        uv = m.kv_lora_rank * a.n_heads * m.v_head_dim
        o = a.n_heads * m.v_head_dim * d
        return q + dkv + uk + uv + o
    if spec.mixer == "mamba":
        m = cfg.mamba
        di = m.expand * d
        in_proj = d * 2 * di
        conv = m.d_conv * di
        x_proj = di * (m.d_state * 2 + _dt_rank(cfg))
        dt_proj = _dt_rank(cfg) * di
        a_d = di * m.d_state + di
        out = di * d
        return in_proj + conv + x_proj + dt_proj + a_d + out
    if spec.mixer == "rwkv":
        r = cfg.rwkv
        # r,k,v,g,o projections + decay/mix loras + per-head u
        return 5 * d * d + 2 * r.decay_lora * d + d + d
    return 0


def _ffn_params(cfg: ModelConfig, spec: LayerSpec, active_only: bool) -> int:
    d = cfg.d_model
    if spec.ffn == "dense":
        mult = 3 if cfg.mlp_kind == "swiglu" else 2
        return mult * d * cfg.d_ff
    if spec.ffn == "rwkv_cm":
        return 2 * d * cfg.d_ff + d * d  # k, v, receptance
    if spec.ffn == "moe":
        m = cfg.moe
        mult = 3  # routed experts are gated (swiglu) in all assigned MoEs
        per_expert = mult * d * m.d_ff_expert
        n = m.top_k if active_only else m.n_experts
        shared = m.n_shared * mult * d * m.d_ff_shared
        router = d * m.n_experts
        return n * per_expert + shared + router
    return 0


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size  # lm head
    layers = list(cfg.prefix) + list(cfg.unit) * cfg.n_repeats
    for spec in layers:
        total += _mixer_params(cfg, spec)
        total += _ffn_params(cfg, spec, active_only)
        total += 2 * cfg.d_model  # norms
    total += cfg.d_model  # final norm
    return total


# ---------------------------------------------------------------------------
# Reduced (smoke-test) configs
# ---------------------------------------------------------------------------

def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config: 1 unit repeat, small dims, for CPU smoke."""
    kw = {}
    if cfg.attention is not None:
        kw["attention"] = dataclasses.replace(
            cfg.attention, n_heads=4, n_kv_heads=2 if cfg.attention.n_kv_heads < cfg.attention.n_heads else 4,
            head_dim=16, chunk_size=32)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
        kw["attention"] = dataclasses.replace(cfg.attention, n_heads=4, n_kv_heads=4, head_dim=16)
    if cfg.moe is not None:
        # capacity_factor high enough to be dropless at smoke scale so
        # teacher-forced forward == token-by-token decode exactly
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=64,
            n_shared=cfg.moe.n_shared, d_ff_shared=64 if cfg.moe.n_shared else 0,
            capacity_factor=8.0)
    if cfg.mamba is not None:
        kw["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8)
    if cfg.vision is not None:
        kw["vision"] = VisionStubConfig(n_tokens=16, dim=48)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        d_model=64,
        vocab_size=256,
        d_ff=128,
        n_repeats=1,
        param_dtype="float32",
        compute_dtype="float32",
        loss_chunk=0,
        **kw,
    )
