"""Parameter specs and initialisation (every branch of the reference's models).

Port of the reference's ``ParamLeaf`` / ``stack_spec`` / ``init_params``
(``models/sharding.py``) and of the spec functions of ``models/model.py``,
``models/attention.py``, ``models/mla.py``, ``models/moe.py``,
``models/rwkv.py`` and ``models/ssm.py``. The shape tree equals the
reference's ``model_spec(cfg)`` for all ten architectures, deepseek's
``prefix_groups`` and ``mtp`` subtrees and seamless's ``encoder`` included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..tree import leaves_with_names, map_leaves
from .model import BlockDef, encoder_layout, main_layout, mixer_of, prefix_cfg, prefix_layout
from .ssm import d_inner


@dataclass
class ParamLeaf:
    """Declarative parameter: shape + logical axes + init."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed | custom
    scale: float | None = None  # overrides the default fan-in scaling
    # Builds one layer's value from the generator (on the generator's
    # device); stacked leaves call it once per layer and stack the results.
    custom: Callable[[torch.Generator], torch.Tensor] | None = None

    def __post_init__(self) -> None:
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _is_leaf(x: Any) -> bool:
    return isinstance(x, ParamLeaf)


def stack_spec(spec: Any, n: int, axis_name: str = "layers") -> Any:
    """Prefix every leaf with a stacked layer axis."""
    return map_leaves(
        lambda leaf: replace(leaf, shape=(n,) + leaf.shape, axes=(axis_name,) + leaf.axes), spec
    )


def spec_shapes(spec: Any) -> Any:
    """The spec tree with each leaf replaced by its shape."""
    return map_leaves(lambda leaf: leaf.shape, spec)


def init_params(spec: Any, generator: torch.Generator, dtype: torch.dtype,
                device: str | torch.device) -> dict:
    """Materialise a parameter tree from a spec tree, directly on ``device``.

    Leaves are drawn in the reference's flatten order (sorted keys) from
    ``generator``, which must live on ``device``. Init rules are the
    reference's: a ``custom`` function (tiled over the stacked layer axes),
    zeros, ones, ``embed`` (normal * 0.02) and a fan-in scaled normal whose
    fan-in is the product of all dims but the last — the stacked layer axis
    included, exactly as the reference computes it.
    """
    dev = resolve_device(device)

    def build(node: Any) -> Any:  # visits leaves in flatten order
        if _is_leaf(node):
            return _init_leaf(node, generator, dtype, dev)
        return {k: build(node[k]) for k in sorted(node)}

    return build(spec)


def _init_leaf(leaf: ParamLeaf, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if leaf.custom is not None:
        base = leaf.custom(gen)
        if base.shape != leaf.shape:  # tile over the stacked leading axes
            stack_dims = leaf.shape[: len(leaf.shape) - base.ndim]
            if leaf.shape != stack_dims + tuple(base.shape):
                raise ValueError(f"custom init gave {tuple(base.shape)} for {leaf.shape}")
            n = 1
            for d in stack_dims:
                n *= d
            base = torch.stack([base] + [leaf.custom(gen) for _ in range(n - 1)])
            base = base.reshape(leaf.shape)
        return base.to(device=device, dtype=dtype)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "embed":
        scale = leaf.scale if leaf.scale is not None else 0.02
    else:
        fan_in = 1
        for d in leaf.shape[:-1]:
            fan_in *= d
        scale = leaf.scale if leaf.scale is not None else (1.0 / max(fan_in, 1)) ** 0.5
    out = torch.randn(leaf.shape, generator=gen, dtype=torch.float32, device=device)
    return out.mul_(scale).to(dtype)


def count_params(spec: Any) -> int:
    total = 0
    for _, leaf in leaves_with_names(spec, is_leaf=_is_leaf):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
    return total


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------


def attn_spec(cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamLeaf((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamLeaf((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamLeaf((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamLeaf((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cross:
        # K/V come from the vision memory (its own width) or the encoder's output;
        # the tanh gate starts at zero, so a fresh cross-attention adds nothing
        mem_d = cfg.vision_embed_dim if cfg.family == "vlm" else cfg.d_model
        spec["wk"] = ParamLeaf((mem_d, kv, hd), ("vision_embed", "kv_heads", "head_dim"))
        spec["wv"] = ParamLeaf((mem_d, kv, hd), ("vision_embed", "kv_heads", "head_dim"))
        spec["gate"] = ParamLeaf((1,), (None,), init="zeros")
    if cfg.qkv_bias:
        spec["bq"] = ParamLeaf((h, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamLeaf((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamLeaf((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _norm_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    spec = {"scale": ParamLeaf((d,), ("embed_noshard",), init="ones")}
    if cfg.norm == "layernorm":
        spec["bias"] = ParamLeaf((d,), ("embed_noshard",), init="zeros")
    return spec


def _mlp_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    spec = {
        "w_in": ParamLeaf((d, f), ("embed", "ffn")),
        "w_out": ParamLeaf((f, d), ("ffn", "embed")),
    }
    if cfg.activation in ("swiglu", "geglu"):
        spec["w_gate"] = ParamLeaf((d, f), ("embed", "ffn"))
    return spec


def mla_spec(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    m = cfg.mla
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "wq_a": ParamLeaf((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": {"scale": ParamLeaf((m.q_lora_rank,), ("lora",), init="ones")},
        "wq_b": ParamLeaf((m.q_lora_rank, h, dn + dr), ("lora", "heads", "qk_dim")),
        "wkv_a": ParamLeaf((d, m.kv_lora_rank + dr), ("embed", "lora")),
        "kv_norm": {"scale": ParamLeaf((m.kv_lora_rank,), ("lora",), init="ones")},
        "wk_b": ParamLeaf((m.kv_lora_rank, h, dn), ("lora", "heads", "qk_dim")),
        "wv_b": ParamLeaf((m.kv_lora_rank, h, dv), ("lora", "heads", "head_dim")),
        "wo": ParamLeaf((h, dv, d), ("heads", "head_dim", "embed")),
    }


def rwkv_time_mix_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    lw = cfg.rwkv.decay_lora
    lm = cfg.rwkv.mix_lora

    def w0_init(gen: torch.Generator) -> torch.Tensor:
        # decay spread across channels (rwkv reference: -6..~0 pre-exp)
        ratio = torch.arange(d, dtype=torch.float32, device=gen.device) / max(d - 1, 1)
        return -6.0 + 5.0 * ratio**0.9

    return {
        "mu_x": ParamLeaf((d,), ("embed",), init="zeros"),
        "mu": ParamLeaf((5, d), (None, "embed"), init="zeros"),
        "mix_a": ParamLeaf((d, 5 * lm), ("embed", "lora"), scale=0.02),
        "mix_b": ParamLeaf((5, lm, d), (None, "lora", "embed"), scale=0.02),
        "w0": ParamLeaf((d,), ("embed",), custom=w0_init),
        "w_a": ParamLeaf((d, lw), ("embed", "lora"), scale=0.02),
        "w_b": ParamLeaf((lw, d), ("lora", "embed"), scale=0.02),
        "u": ParamLeaf((d,), ("embed",), init="zeros"),
        "wr": ParamLeaf((d, d), ("embed", "inner")),
        "wk": ParamLeaf((d, d), ("embed", "inner")),
        "wv": ParamLeaf((d, d), ("embed", "inner")),
        "wg": ParamLeaf((d, d), ("embed", "inner")),
        "wo": ParamLeaf((d, d), ("inner", "embed")),
        "ln_x": {
            "scale": ParamLeaf((d,), ("embed",), init="ones"),
            "bias": ParamLeaf((d,), ("embed",), init="zeros"),
        },
    }


def rwkv_channel_mix_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamLeaf((d,), ("embed",), init="zeros"),
        "mu_r": ParamLeaf((d,), ("embed",), init="zeros"),
        "wk": ParamLeaf((d, f), ("embed", "ffn")),
        "wv": ParamLeaf((f, d), ("ffn", "embed")),
        "wr": ParamLeaf((d, d), ("embed", "inner")),
    }


def mamba_spec(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, d_inner(cfg)
    n, r, cw = cfg.mamba.state_dim, cfg.mamba.dt_rank, cfg.mamba.conv_width

    def a_log_init(gen: torch.Generator) -> torch.Tensor:
        a = torch.arange(1, n + 1, dtype=torch.float32, device=gen.device)[None, :].repeat(di, 1)
        return torch.log(a)

    def dt_bias_init(gen: torch.Generator) -> torch.Tensor:
        # dt in [1e-3, 1e-1] after softplus (mamba reference init)
        u = torch.rand((di,), generator=gen, dtype=torch.float32, device=gen.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))

    return {
        "in_proj": ParamLeaf((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamLeaf((cw, di), ("conv", "inner"), scale=(1.0 / cw) ** 0.5),
        "conv_b": ParamLeaf((di,), ("inner",), init="zeros"),
        "x_proj": ParamLeaf((di, r + 2 * n), ("inner", "dt_rank")),
        "dt_w": ParamLeaf((r, di), ("dt_rank", "inner"), scale=r**-0.5),
        "dt_b": ParamLeaf((di,), ("inner",), custom=dt_bias_init),
        "a_log": ParamLeaf((di, n), ("inner", "state"), custom=a_log_init),
        "d_skip": ParamLeaf((di,), ("inner",), init="ones"),
        "out_proj": ParamLeaf((di, d), ("inner", "embed")),
        "dt_norm": {"scale": ParamLeaf((r,), ("dt_rank",), init="ones")},
        "b_norm": {"scale": ParamLeaf((n,), ("state",), init="ones")},
        "c_norm": {"scale": ParamLeaf((n,), ("state",), init="ones")},
    }


def moe_spec(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.expert_d_ff
    spec = {
        "router": ParamLeaf((d, e), ("embed", "experts"), scale=0.02),
        "w_gate": ParamLeaf((e, d, f), ("experts", "expert_embed", "expert_ffn")),
        "w_up": ParamLeaf((e, d, f), ("experts", "expert_embed", "expert_ffn")),
        "w_down": ParamLeaf((e, f, d), ("experts", "expert_ffn", "expert_embed")),
    }
    if cfg.moe.num_shared_experts > 0:
        fs = f * cfg.moe.num_shared_experts
        spec["shared_gate"] = ParamLeaf((d, fs), ("embed", "ffn"))
        spec["shared_up"] = ParamLeaf((d, fs), ("embed", "ffn"))
        spec["shared_down"] = ParamLeaf((fs, d), ("ffn", "embed"))
    return spec


_MIXER_SPECS = {"attn": attn_spec, "attn_x": attn_spec, "xattn": partial(attn_spec, cross=True),
                "mla": mla_spec, "rwkv": rwkv_time_mix_spec, "mamba": mamba_spec}
_MLP_SPECS = {"dense": _mlp_spec, "moe": moe_spec, "rwkv_cm": rwkv_channel_mix_spec}


def _block_spec(bdef: BlockDef, cfg: ModelConfig) -> dict:
    spec = {
        "norm1": _norm_spec(cfg),
        "mixer": _MIXER_SPECS[bdef.mixer](cfg),
        "mlp": _MLP_SPECS[bdef.mlp](cfg),
        "norm2": _norm_spec(cfg),
    }
    if bdef.mixer == "attn_x":  # seamless decoder: a cross-attention sub-layer after self-attention
        spec["xattn"] = attn_spec(cfg, cross=True)
        spec["norm_x"] = _norm_spec(cfg)
    return spec


def _groups_spec(layout, cfg: ModelConfig) -> dict:
    return stack_spec({f"b{i}": _block_spec(b, cfg) for i, b in enumerate(layout.group)},
                      layout.num_groups)


def model_spec(cfg: ModelConfig) -> dict:
    spec: dict[str, Any] = {
        "embed": ParamLeaf((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed"),
        "groups": _groups_spec(main_layout(cfg), cfg),
        "norm_f": _norm_spec(cfg),
    }
    if not cfg.tied_embeddings:
        spec["lm_head"] = ParamLeaf((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    if cfg.dense_prefix_layers > 0:  # deepseek: dense-MLP layers ahead of the MoE ones
        spec["prefix_groups"] = _groups_spec(prefix_layout(cfg), prefix_cfg(cfg))
    if cfg.is_encdec:  # seamless: the bidirectional encoder over projected source frames
        spec["encoder"] = {
            "proj": ParamLeaf((cfg.audio_embed_dim, cfg.d_model), ("vision_embed", "embed")),
            "groups": _groups_spec(encoder_layout(cfg), cfg),
            "norm_f": _norm_spec(cfg),
        }
    if cfg.mtp_depth > 0:  # one block of the main cfg: its MLP is d_ff wide
        spec["mtp"] = {
            "proj": ParamLeaf((2 * cfg.d_model, cfg.d_model), ("embed_noshard", "embed")),
            "norm_in": _norm_spec(cfg),
            "block": _block_spec(BlockDef(mixer_of(cfg), "dense"), cfg),
        }
    return spec
