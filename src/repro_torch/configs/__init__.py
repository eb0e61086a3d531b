"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures whose modules are ported are registered; any other
id raises ``KeyError`` naming it as not yet ported. jamba is registered
for its variants without experts: MoE is not ported, so its published
``full()`` config raises ``NotImplementedError`` when a model is laid out.
"""

from __future__ import annotations

from . import granite_3_8b, jamba_1_5_large_398b, rwkv6_7b, stablelm_3b
from .base import ModelConfig, TrainConfig

ARCHS: dict[str, object] = {
    m.ARCH_ID: m for m in (stablelm_3b, granite_3_8b, rwkv6_7b, jamba_1_5_large_398b)
}
ARCH_IDS: list[str] = list(ARCHS.keys())


def get_config(arch: str, variant: str = "full") -> ModelConfig:
    """variant: 'full' (published widths), 'smoke' (reduced, CPU-runnable)
    or one of the arch module's ``VARIANTS`` (e.g. jamba's ``no-moe``)."""
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not yet ported to repro_torch; ported: {ARCH_IDS}")
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
    "ModelConfig",
    "TrainConfig",
    "get_config",
]
