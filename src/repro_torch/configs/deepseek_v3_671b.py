"""deepseek-v3-671b [moe] — 61L d_model=7168 128H (GQA kv=128) d_ff=2048
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

MLA caches only the 512-rank latent + 64-dim shared RoPE key per token
(decode uses matrix absorption). First 3 layers use a dense
18432-wide MLP (HF config); remaining 58 are MoE. MTP at depth 1.

``full()`` and ``smoke()`` are copies of the reference's. ``full()``
holds 671,360,333,824 params and does not fit one 80 GB card. Keeping
the 3 dense-prefix layers and the MTP block, each MoE layer adds
11,507,286,016 params: 1 MoE layer gives 15,445,030,912 (30.89 GB in
bf16), 2 give 26,952,316,928 (53.90 GB) and 3 give 38,459,602,944 (76.92
GB, no room left for the cache, the activations or the dispatch
tensors). So the port serves ``two-moe`` from ``VARIANTS`` on one card:
every published width (256 routed experts top-8 of d_ff 2048 plus one
shared, MLA with q rank 1536 and kv rank 512, 128 heads, the 3 dense
prefix layers of d_ff 18432, vocab 129,280, MTP depth 1) and 2 of the 58
MoE layers, 5 of 61 layers in all.
"""

from .base import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v3-671b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        source="arXiv:2412.19437; hf",
        num_layers=58,  # + 3 dense-prefix layers = 61 total
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=2048,
        vocab_size=129280,
        attention="mla",
        rope_theta=10000.0,
        activation="swiglu",
        norm="rmsnorm",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=256,
            num_shared_experts=1,
            top_k=8,
            expert_d_ff=2048,
            moe_every=1,
            capacity_factor=1.25,
            group_size=2048,
        ),
        mtp_depth=1,
        dense_prefix_layers=3,
        prefix_d_ff=18432,
        sharding_rules="fsdp",
        rules_overrides={"expert_ffn": "data"},
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=271,
        mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        ),
        moe=MoEConfig(
            num_experts=8, num_shared_experts=1, top_k=2, expert_d_ff=96,
            moe_every=1, capacity_factor=2.0, group_size=64,
        ),
        dense_prefix_layers=1,
        prefix_d_ff=192,
        sharding_rules="tp",
    )


VARIANTS = {"two-moe": lambda: full().copy(num_layers=2)}
