"""PyTorch model substrate (dense branch of the reference's models)."""

from .model import BlockDef, Layout, decode_step, decoder_layout, forward, pad_cache, prefill
from .spec import ParamLeaf, count_params, init_params, model_spec, spec_shapes, stack_spec

__all__ = [
    "BlockDef",
    "Layout",
    "ParamLeaf",
    "count_params",
    "decode_step",
    "decoder_layout",
    "forward",
    "init_params",
    "model_spec",
    "pad_cache",
    "prefill",
    "spec_shapes",
    "stack_spec",
]
