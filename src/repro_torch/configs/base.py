"""Model and training configuration: copies of the reference's
``ModelConfig`` with its sub-configs, of its ``TrainConfig`` and of the
dry-run's cells (``ShapeConfig``, ``SHAPES``), so the port never imports
the JAX package.

The fields and defaults are kept identical to the reference so that a
config built on either side describes the same model.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any


@dataclass
class MoEConfig:
    num_experts: int = 0  # routed experts; 0 = dense MLP
    num_shared_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0  # per-expert hidden; defaults to d_ff
    capacity_factor: float = 1.25
    group_size: int = 1024  # dispatch group (GShard-style) bounds T*E*C cost
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3
    moe_every: int = 1  # MoE replaces the MLP every k-th layer


@dataclass
class MambaConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass
class RwkvConfig:
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclass
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    source: str = ""  # provenance tag from the assignment pool

    # Core transformer dims
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # Attention details
    attention: str = "gqa"  # gqa | mla | none (ssm)
    qkv_bias: bool = False
    use_rope: bool = True  # jamba: no positional encoding
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention
    tied_embeddings: bool = False
    activation: str = "swiglu"  # swiglu | gelu | geglu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5

    # Sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    rwkv: RwkvConfig = field(default_factory=RwkvConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)

    # Hybrid layout (jamba): period-P group, attention at index attn_index
    hybrid_period: int = 0  # 0 = not hybrid
    hybrid_attn_index: int = 4

    # VLM: cross-attention every k-th layer over precomputed patch embeddings
    cross_attn_every: int = 0  # 0 = no cross-attn layers
    vision_embed_dim: int = 1280
    num_patches: int = 1601

    # Audio/enc-dec (seamless): encoder layers + frame-embedding frontend stub
    encoder_layers: int = 0  # 0 = decoder-only
    audio_embed_dim: int = 1024
    max_src_len: int = 4096

    # DeepSeek extras
    mtp_depth: int = 0  # multi-token-prediction blocks (predict t+2)
    dense_prefix_layers: int = 0  # first k layers use a dense MLP (deepseek: 3)
    prefix_d_ff: int = 0  # dense-prefix hidden size (deepseek: 18432)

    # Numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logits_dtype: str = "float32"

    # Execution strategy
    q_chunk: int = 512  # query-block size for chunked attention (0 = naive)
    scan_layers: bool = True
    remat: str = "full"  # none | full | dots (checkpoint policy per block)
    # On a CUDA tensor the hand-written kernel always runs; on the CPU this
    # picks the kernel's plain twin (True) or the chunked path (False).
    use_pallas: bool = False
    sharding_rules: str = "tp"  # tp | fsdp
    rules_overrides: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.num_heads > 0:
            self.head_dim = self.d_model // self.num_heads
        if self.mamba.dt_rank == 0:
            self.mamba.dt_rank = max(1, (self.d_model + 15) // 16)
        if self.moe.num_experts and self.moe.expert_d_ff == 0:
            self.moe.expert_d_ff = self.d_ff

    # -- derived -----------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state, hybrid, or sliding-window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def copy(self, **kw: Any) -> "ModelConfig":
        return replace(self, **kw)


@dataclass
class ShapeConfig:
    """One (input-shape) cell of the dry-run grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass
class TrainConfig:
    """Optimizer / loop hyper-parameters (paper-independent substrate)."""

    optimizer: str = "adamw"  # adamw | adafactor
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation
    seed: int = 0
    checkpoint_every: int = 50
    mtp_loss_weight: float = 0.3
