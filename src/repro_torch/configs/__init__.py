"""Architecture registry of the port: ``--arch <id>`` resolves here.

All ten of the reference's architectures are registered; any other id
raises ``KeyError``. An arch module may add variants of its own in
``VARIANTS``: jamba's without experts, mixtral's ``half-depth`` and
deepseek's ``two-moe``, which fit one card.
"""

from __future__ import annotations

from . import (
    deepseek_v3_671b, granite_3_8b, jamba_1_5_large_398b, llama_3_2_vision_11b, mixtral_8x7b,
    qwen2_5_14b, rwkv6_7b, seamless_m4t_large_v2, stablelm_3b, starcoder2_15b,
)
from .base import SHAPES, ModelConfig, ShapeConfig, TrainConfig

ARCHS: dict[str, object] = {
    m.ARCH_ID: m for m in (starcoder2_15b, qwen2_5_14b, stablelm_3b, granite_3_8b,
                           jamba_1_5_large_398b, rwkv6_7b, llama_3_2_vision_11b, mixtral_8x7b,
                           deepseek_v3_671b, seamless_m4t_large_v2)  # the reference's order
}
ARCH_IDS: list[str] = list(ARCHS.keys())


def get_config(arch: str, variant: str = "full") -> ModelConfig:
    """variant: 'full' (published widths), 'smoke' (reduced, CPU-runnable)
    or one of the arch module's ``VARIANTS`` (e.g. jamba's ``no-moe``,
    mixtral's ``half-depth``, deepseek's ``two-moe``)."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = ARCHS[arch]
    if variant == "full":
        return mod.full()
    if variant == "smoke":
        return mod.smoke()
    variants = getattr(mod, "VARIANTS", {})
    if variant in variants:
        return variants[variant]()
    raise KeyError(f"unknown variant {variant!r} ({'|'.join(['full', 'smoke', *variants])})")


__all__ = [
    "ARCHS",
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "get_config",
]
