"""rwkv6-7b [ssm] — 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; hf]."""

from .base import ModelConfig, RwkvConfig

ARCH_ID = "rwkv6-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        source="arXiv:2404.05892; hf",
        num_layers=32,
        d_model=4096,
        num_heads=64,  # d_model / head_size
        num_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        attention="none",
        norm="layernorm",  # rwkv reference uses LN
        rwkv=RwkvConfig(head_size=64, decay_lora=64, mix_lora=32),
        sharding_rules="fsdp",
    )


def smoke() -> ModelConfig:
    return full().copy(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=0,
        d_ff=224,
        vocab_size=256,
        rwkv=RwkvConfig(head_size=16, decay_lora=8, mix_lora=8),
        sharding_rules="tp",
    )
