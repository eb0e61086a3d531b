"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Layout: period-8 groups (attention at index 4, Mamba elsewhere), MoE
replaces the MLP on every other layer — 9 scanned groups of 8 layers.
Jamba uses no explicit positional encoding (the Mamba layers carry it).

``full()`` and ``smoke()`` are copies of the reference's. MoE is not
ported yet, so the port serves the two variants without experts in
``VARIANTS``: every MLP is then a dense SwiGLU of d_ff 24576, as the
reference's own layout makes it with ``MoEConfig()``. ``no-moe`` keeps
every published width and cuts depth to 2 groups (16 layers: 14 Mamba, 2
attention; 16,924,327,360 params, 33.85 GB in bf16), which fits one 80 GB
card with room for serving.
"""

from .base import MambaConfig, ModelConfig, MoEConfig

ARCH_ID = "jamba-1.5-large-398b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        source="arXiv:2403.19887; hf",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        attention="gqa",
        use_rope=False,
        activation="swiglu",
        norm="rmsnorm",
        hybrid_period=8,
        hybrid_attn_index=4,
        mamba=MambaConfig(state_dim=16, conv_width=4, expand=2),
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            expert_d_ff=24576,
            moe_every=2,
            capacity_factor=1.25,
            group_size=2048,
        ),
        sharding_rules="fsdp",
        rules_overrides={"expert_ffn": "data"},
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=8,  # one period group
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=0,
        d_ff=192,
        vocab_size=256,
        mamba=MambaConfig(state_dim=4, conv_width=4, expand=2),
        moe=MoEConfig(
            num_experts=4, top_k=2, expert_d_ff=192, moe_every=2,
            capacity_factor=2.0, group_size=64,
        ),
        sharding_rules="tp",
    )


VARIANTS = {
    "no-moe": lambda: full().copy(num_layers=16, moe=MoEConfig()),
    "smoke-no-moe": lambda: smoke().copy(moe=MoEConfig()),
}
