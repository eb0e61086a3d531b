"""Input-shape cells and their abstract inputs (the dry-run plane).

Port of the reference's ``configs/shapes.py``. Four cells per
architecture (40 in all):
  train_4k    : seq 4,096  x global_batch 256  -> train step
  prefill_32k : seq 32,768 x global_batch 32   -> prefill (serve)
  decode_32k  : 1 new token, KV/state context 32,768, batch 128 -> decode step
  long_500k   : 1 new token, context 524,288, batch 1 -> decode step
                (sub-quadratic archs only: ssm / hybrid / SWA)

``input_specs`` returns the inputs of a cell's step as tensors on the meta
device: shapes and dtypes without memory, leaf for leaf the reference's
``ShapeDtypeStruct`` trees. ``pos`` is a 0-dim int32 tensor, as in the
reference; the port's ``decode_step`` still takes a Python int.
"""

from __future__ import annotations

import torch

from ..models.model import abstract_cache, dtype_of
from .base import SHAPES, ModelConfig, ShapeConfig


class CellSkip(Exception):
    """This (arch x shape) cell is skipped by design; .reason says why."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return (
            "long_500k requires sub-quadratic decode; "
            f"{cfg.name} is pure full-attention (see DESIGN.md §Arch-applicability)"
        )
    return None


def _mem_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Cross-attention memory length for vlm/audio archs."""
    if cfg.cross_attn_every > 0:
        return cfg.num_patches
    if cfg.is_encdec:
        return min(cfg.max_src_len, shape.seq_len)
    return 0


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Full-sequence inputs (train / prefill)."""
    b, s = shape.global_batch, shape.seq_len
    cdtype = dtype_of(cfg.compute_dtype)
    specs = {"tokens": _meta((b, s), torch.int32)}
    if cfg.cross_attn_every > 0:
        specs["image_embeds"] = _meta((b, cfg.num_patches, cfg.vision_embed_dim), cdtype)
    if cfg.is_encdec:
        specs["src_frames"] = _meta((b, _mem_len(cfg, shape), cfg.audio_embed_dim), cdtype)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Decode-step inputs: one new token + the cache at context length."""
    b, s = shape.global_batch, shape.seq_len
    return {
        "tokens": _meta((b, 1), torch.int32),
        "cache": abstract_cache(cfg, b, s, mem_len=_mem_len(cfg, shape)),
        "pos": _meta((), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str) -> dict:
    """Abstract inputs for the given cell; raises CellSkip when inapplicable."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    reason = cell_skip_reason(cfg, shape)
    if reason:
        raise CellSkip(reason)
    if shape.kind in ("train", "prefill"):
        return batch_specs(cfg, shape)
    return decode_specs(cfg, shape)
