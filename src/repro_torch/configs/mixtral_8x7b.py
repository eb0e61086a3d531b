"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2 — 8 experts top-2, SWA [arXiv:2401.04088; hf].

Sliding-window attention (4096) makes decode O(window): the KV cache is a
ring buffer, so the long_500k cell runs with constant memory.
8 experts < the 16-wide model axis, so EP shards each expert's d_ff
instead of the expert dim (see rules_overrides).

``full()`` and ``smoke()`` are copies of the reference's. ``full()`` holds
46.7 B params, 93.4 GB in bf16, which does not fit one 80 GB card, so the
port serves ``half-depth`` from ``VARIANTS`` on one: every published width
(experts, window, vocabulary) and 16 of the 32 layers, 23,482,470,400
params, 46.96 GB in bf16, with room for the cache and the dispatch
tensors.
"""

from .base import ModelConfig, MoEConfig

ARCH_ID = "mixtral-8x7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        source="arXiv:2401.04088; hf",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        attention="gqa",
        rope_theta=1000000.0,
        sliding_window=4096,
        activation="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            expert_d_ff=14336,
            moe_every=1,
            capacity_factor=1.25,
            group_size=2048,
        ),
        sharding_rules="fsdp",
        rules_overrides={"experts": None, "expert_ffn": "model", "expert_embed": "data"},
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=0,
        d_ff=192,
        vocab_size=256,
        sliding_window=8,
        moe=MoEConfig(
            num_experts=4, top_k=2, expert_d_ff=192, moe_every=1,
            capacity_factor=2.0, group_size=64,
        ),
        sharding_rules="tp",
        rules_overrides={},
    )


VARIANTS = {"half-depth": lambda: full().copy(num_layers=16)}
