"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf]."""

from .base import ModelConfig

ARCH_ID = "starcoder2-15b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="arXiv:2402.19173; hf",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        attention="gqa",
        qkv_bias=True,
        rope_theta=100000.0,
        activation="gelu",  # plain 4x MLP (d_ff = 4 d_model)
        norm="layernorm",
        sharding_rules="fsdp",
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=0,
        d_ff=384,
        vocab_size=257,
        sharding_rules="tp",
    )
