"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b; unverified]."""

from .base import ModelConfig

ARCH_ID = "stablelm-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b; unverified",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,  # kv=32 -> plain MHA
        d_ff=6912,
        vocab_size=50304,
        attention="gqa",
        qkv_bias=False,
        rope_theta=10000.0,
        activation="swiglu",
        norm="layernorm",
        sharding_rules="tp",
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=0,
        d_ff=176,
        vocab_size=256,
    )
