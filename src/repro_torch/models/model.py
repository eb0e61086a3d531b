"""Model assembly: forward, prefill and decode.

Port of the reference's ``models/model.py`` for the ported layouts: dense
decoder-only models (stablelm, granite), a group of one ``[attn + mlp]``
block; RWKV-6, a group of one ``[time-mix + channel-mix]`` block, each
tiled ``num_layers`` times; and the jamba hybrid without experts, a group
of ``hybrid_period`` blocks (attention at ``hybrid_attn_index``, Mamba
elsewhere, each with a dense MLP) tiled ``num_layers / hybrid_period``
times. Parameters keep the reference's stacked ``(num_groups, ...)``
leaves so converted weights map one to one; the groups run in a Python
loop. Under grad with ``cfg.remat == "full"`` each group runs inside a
non-reentrant ``torch.utils.checkpoint`` and is recomputed in the
backward pass, as the reference wraps its scan body in ``jax.checkpoint``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..tree import map_leaves
from . import attention as attn
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .layers import activate, apply_norm

# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockDef:
    mixer: str  # attn | rwkv | mamba (the mixers ported so far)
    mlp: str  # dense | rwkv_cm


@dataclass(frozen=True)
class Layout:
    group: tuple[BlockDef, ...]
    num_groups: int

    @property
    def num_layers(self) -> int:
        return len(self.group) * self.num_groups


def decoder_layout(cfg: ModelConfig) -> Layout:
    """The dense, RWKV and jamba (without experts) cases of the reference's
    layout; other families are not ported."""
    if cfg.family == "ssm":
        return Layout((BlockDef("rwkv", "rwkv_cm"),), cfg.num_layers)
    if cfg.hybrid_period > 0:  # jamba
        if cfg.moe.num_experts > 0:
            raise NotImplementedError(
                f"{cfg.name}: MoE is not ported to repro_torch; serve the variant without "
                f"experts (--variant no-moe)")
        blocks = tuple(
            BlockDef("attn" if i == cfg.hybrid_attn_index else "mamba", "dense")
            for i in range(cfg.hybrid_period)
        )
        return Layout(blocks, cfg.num_layers // cfg.hybrid_period)
    if (
        cfg.cross_attn_every > 0 or cfg.attention == "mla" or cfg.moe.num_experts > 0
        or cfg.is_encdec or cfg.dense_prefix_layers > 0 or cfg.mtp_depth > 0
    ):
        raise NotImplementedError(
            f"{cfg.name}: only the dense, RWKV-6 and jamba (no-moe) branches are ported "
            f"to repro_torch")
    return Layout((BlockDef("attn", "dense"),), cfg.num_layers)


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _mlp_fwd(mlp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gated = "w_gate" in mlp
    gate = attn.matmul_promote(h, mlp["w_gate"] if gated else mlp["w_in"])
    up = attn.matmul_promote(h, mlp["w_in"]) if gated else None
    return attn.matmul_promote(activate(gate, up, cfg.activation), mlp["w_out"])


def _block_fwd(bdef: BlockDef, bp: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, return_cache: bool):
    """Pre-norm residual block. Returns (x, cache or None); the cache holds
    the mixer's leaves and, for the channel mix, ``{"cm": ...}``."""
    h = apply_norm(x, bp["norm1"], cfg.norm, cfg.norm_eps)
    if bdef.mixer == "attn":
        res = attn.attn_fwd(bp["mixer"], h, cfg, positions, return_cache=return_cache)
    elif bdef.mixer == "rwkv":
        res = rwkv_mod.rwkv_time_mix_fwd(bp["mixer"], h, cfg, return_cache=return_cache)
    elif bdef.mixer == "mamba":
        res = ssm_mod.mamba_fwd(bp["mixer"], h, cfg, return_cache=return_cache)
    else:
        raise ValueError(bdef.mixer)
    out, cache = res if return_cache else (res, None)
    x = x + out
    h = apply_norm(x, bp["norm2"], cfg.norm, cfg.norm_eps)
    if bdef.mlp == "dense":
        return x + _mlp_fwd(bp["mlp"], h, cfg), cache
    if bdef.mlp != "rwkv_cm":
        raise ValueError(bdef.mlp)
    res = rwkv_mod.rwkv_channel_mix_fwd(bp["mlp"], h, cfg, return_cache=return_cache)
    if not return_cache:
        return x + res, None
    out, cm = res
    return x + out, dict(cache, cm=cm)


def _group_fwd(layout: Layout, gparams: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, return_cache: bool) -> tuple[torch.Tensor, dict]:
    gcache = {}
    for i, bdef in enumerate(layout.group):
        x, gcache[f"b{i}"] = _block_fwd(bdef, gparams[f"b{i}"], x, cfg, positions, return_cache)
    return x, gcache


def _remat_groups(cfg: ModelConfig) -> bool:
    """Whether to recompute each group in the backward pass, as the
    reference's ``jax.checkpoint`` around its scan body does. Only under
    grad: serving (``inference_mode``) runs every group once either way."""
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return False
    if cfg.remat == "full":
        return True
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat 'dots' (save only the matrix products' outputs) is not ported to repro_torch "
            "(ROADMAP queue A); use 'full' or 'none'")
    raise ValueError(f"unknown remat {cfg.remat!r} (none | full | dots)")


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return attn.matmul_promote(x, head).to(dtype_of(cfg.logits_dtype))


def _zero_aux(device: torch.device) -> dict:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": zero, "z_loss": zero.clone()}


def forward(params: dict, cfg: ModelConfig, batch: dict, *, return_cache: bool = False):
    """Full-sequence forward. batch: {"tokens": (B, S) integer tensor}.

    Returns (logits, aux[, cache]); cache leaves are stacked (num_groups, ...).
    """
    layout = decoder_layout(cfg)
    tokens = batch["tokens"].long()
    x = params["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    positions = torch.arange(tokens.shape[1], device=x.device)
    remat = not return_cache and _remat_groups(cfg)
    # one view per group of every stacked leaf: under grad, unbind's backward
    # stacks the groups' gradients once, where indexing would add a zero-filled
    # gradient of the whole stacked leaf for every group
    groups = map_leaves(lambda p: p.unbind(0), params["groups"])
    caches = []
    for g in range(layout.num_groups):
        gparams = map_leaves(lambda views: views[g], groups)
        if remat:
            x = checkpoint(lambda x, gp: _group_fwd(layout, gp, x, cfg, positions, False)[0],
                           x, gparams, use_reentrant=False, preserve_rng_state=False)
        else:
            x, gcache = _group_fwd(layout, gparams, x, cfg, positions, return_cache)
            caches.append(gcache)
    logits = _logits(params, cfg, apply_norm(x, params["norm_f"], cfg.norm, cfg.norm_eps))
    out = (logits, _zero_aux(x.device))
    if return_cache:
        stacked = map_leaves(lambda *leaves: torch.stack(leaves), *caches)
        out += ({"layers": stacked, "memory": None},)
    return out


_SEQ_CACHE_KEYS = ("k", "v", "c_kv", "k_rope")  # leaves with a seq axis at dim 2


def pad_cache(cache: dict, cfg: ModelConfig, max_len: int) -> dict:
    """Grow the sequence-indexed leaves, stacked (groups, B, S, ...), to the
    decode cache length. State leaves (RWKV's ``wkv`` and ``x_prev``,
    Mamba's ``h`` and ``conv``) are left as they are; ring buffers (SWA)
    never grow past the window."""
    target = attn.cache_len(cfg, max_len)

    def walk(tree: dict) -> dict:
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in _SEQ_CACHE_KEYS and val.ndim >= 3:
                tgt = target if key in ("k", "v") else max_len
                s = val.shape[2]
                pad = [0, 0] * (val.ndim - 3) + [0, tgt - s]
                out[key] = F.pad(val, pad) if s < tgt else val
            else:
                out[key] = val
        return out

    return dict(cache, layers=walk(cache["layers"]))


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int | None = None):
    """Full-context forward returning last-position logits + decode cache."""
    logits, _, cache = forward(params, cfg, batch, return_cache=True)
    if max_len is not None:
        cache = pad_cache(cache, cfg, max_len)
    return logits[:, -1:], cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _block_decode(bdef: BlockDef, bp: dict, x: torch.Tensor, cache: dict, pos: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """One token through one block. ``cache`` holds views of this layer's
    slice of the stacked cache; every mixer writes into them in place."""
    h = apply_norm(x, bp["norm1"], cfg.norm, cfg.norm_eps)
    if bdef.mixer == "attn":
        out, _ = attn.attn_decode(bp["mixer"], h, {"k": cache["k"], "v": cache["v"]}, pos, cfg)
    elif bdef.mixer == "rwkv":
        out, _ = rwkv_mod.rwkv_time_mix_decode(
            bp["mixer"], h, {"wkv": cache["wkv"], "x_prev": cache["x_prev"]}, cfg)
    elif bdef.mixer == "mamba":
        out, _ = ssm_mod.mamba_decode(bp["mixer"], h, {"h": cache["h"], "conv": cache["conv"]}, cfg)
    else:
        raise ValueError(bdef.mixer)
    x = x + out
    h = apply_norm(x, bp["norm2"], cfg.norm, cfg.norm_eps)
    if bdef.mlp == "dense":
        return x + _mlp_fwd(bp["mlp"], h, cfg)
    if bdef.mlp != "rwkv_cm":
        raise ValueError(bdef.mlp)
    out, _ = rwkv_mod.rwkv_channel_mix_decode(bp["mlp"], h, cache["cm"], cfg)
    return x + out


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos: int):
    """One token for the whole batch. tokens: (B, 1). Returns (logits, cache).

    The cache is updated in place: each group's slice is a view of the
    stacked leaves, and the mixers write into it.
    """
    layout = decoder_layout(cfg)
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    for g in range(layout.num_groups):
        gparams = map_leaves(lambda p: p[g], params["groups"])
        for i, bdef in enumerate(layout.group):
            lcache = map_leaves(lambda c: c[g], cache["layers"][f"b{i}"])
            x = _block_decode(bdef, gparams[f"b{i}"], x, lcache, pos, cfg)
    logits = _logits(params, cfg, apply_norm(x, params["norm_f"], cfg.norm, cfg.norm_eps))
    return logits, cache
