"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""

from .base import ModelConfig

ARCH_ID = "granite-3-8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="hf:ibm-granite/granite-3.0-2b-base; hf",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        attention="gqa",
        qkv_bias=False,
        rope_theta=10000.0,
        activation="swiglu",
        norm="rmsnorm",
        tied_embeddings=True,  # granite ties input/output embeddings
        sharding_rules="fsdp",
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=0,
        d_ff=208,
        vocab_size=259,
        sharding_rules="tp",
    )
