"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""

from .base import ModelConfig

ARCH_ID = "qwen2.5-14b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B; hf",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        attention="gqa",
        qkv_bias=True,
        rope_theta=1000000.0,
        activation="swiglu",
        norm="rmsnorm",
        sharding_rules="fsdp",
        # 40 heads do not divide the 16-wide model axis (and jit input
        # shardings cannot pad), so this arch runs SEQUENCE-PARALLEL: the
        # residual stream's seq dim is sharded on "model", attention heads
        # and ffn stay unsharded, weights are FSDP-sharded over "data".
        # See EXPERIMENTS.md §Perf (qwen iteration 1): 16x compute
        # parallelism for the price of one x all-gather per layer.
        rules_overrides={
            "heads": None, "kv_heads": None, "ffn": None, "vocab": None,
            "seq": "model", "embed": ("data", "model"),
        },
        q_chunk=256,  # 32768/256 and 4096/256 blocks divide the model axis
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=2,
        d_model=80,
        num_heads=5,
        num_kv_heads=1,
        head_dim=0,
        d_ff=192,
        vocab_size=311,
        sharding_rules="tp",
    )
