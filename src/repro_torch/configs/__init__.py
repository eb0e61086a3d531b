"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures whose every module is ported are registered; any
other id raises ``KeyError`` naming it as not yet ported.
"""

from __future__ import annotations

from . import granite_3_8b, rwkv6_7b, stablelm_3b
from .base import ModelConfig

ARCHS: dict[str, object] = {m.ARCH_ID: m for m in (stablelm_3b, granite_3_8b, rwkv6_7b)}
ARCH_IDS: list[str] = list(ARCHS.keys())


def get_config(arch: str, variant: str = "full") -> ModelConfig:
    """variant: 'full' (published widths) or 'smoke' (reduced, CPU-runnable)."""
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not yet ported to repro_torch; ported: {ARCH_IDS}")
    mod = ARCHS[arch]
    if variant == "full":
        return mod.full()
    if variant == "smoke":
        return mod.smoke()
    raise KeyError(f"unknown variant {variant!r} (full|smoke)")


__all__ = [
    "ARCHS",
    "ARCH_IDS",
    "ModelConfig",
    "get_config",
]
