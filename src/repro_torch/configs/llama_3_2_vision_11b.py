"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256 — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

The vision frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings (B, 1601, 1280); every 5th layer is
a tanh-gated cross-attention layer over them (8 of 40).
"""

from .base import ModelConfig

ARCH_ID = "llama-3.2-vision-11b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        attention="gqa",
        rope_theta=500000.0,
        activation="swiglu",
        norm="rmsnorm",
        cross_attn_every=5,
        vision_embed_dim=1280,
        num_patches=1601,
        sharding_rules="fsdp",
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=5,  # one cross-attn group
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=0,
        d_ff=224,
        vocab_size=256,
        vision_embed_dim=32,
        num_patches=17,
        sharding_rules="tp",
    )
