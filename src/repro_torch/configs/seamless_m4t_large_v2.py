"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Backbone only per the assignment: the speech frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings (B, S_src, 1024).
24-layer bidirectional encoder + 24-layer decoder with per-layer
cross-attention.
"""

from .base import ModelConfig

ARCH_ID = "seamless-m4t-large-v2"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        source="arXiv:2308.11596; hf",
        num_layers=24,  # decoder
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        attention="gqa",
        activation="gelu",
        norm="layernorm",
        audio_embed_dim=1024,
        max_src_len=4096,
        sharding_rules="tp",
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=0,
        d_ff=256,
        vocab_size=517,
        audio_embed_dim=32,
        max_src_len=64,
    )
