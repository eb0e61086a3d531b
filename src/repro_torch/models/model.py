"""Model assembly, dense branch: forward, prefill and decode.

Port of the reference's ``models/model.py`` for dense decoder-only
architectures (stablelm, granite): a group of one ``[attn + mlp]`` block,
tiled ``num_layers`` times. Parameters keep the reference's stacked
``(num_groups, ...)`` leaves so converted weights map one to one; the
groups run in a Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..tree import map_leaves
from . import attention as attn
from .layers import activate, apply_norm

# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockDef:
    mixer: str  # attn (the only mixer ported so far)
    mlp: str  # dense


@dataclass(frozen=True)
class Layout:
    group: tuple[BlockDef, ...]
    num_groups: int

    @property
    def num_layers(self) -> int:
        return len(self.group) * self.num_groups


def decoder_layout(cfg: ModelConfig) -> Layout:
    """Dense case of the reference's layout; other families are not ported."""
    if (
        cfg.family == "ssm" or cfg.hybrid_period > 0 or cfg.cross_attn_every > 0
        or cfg.attention == "mla" or cfg.moe.num_experts > 0 or cfg.is_encdec
        or cfg.dense_prefix_layers > 0 or cfg.mtp_depth > 0
    ):
        raise NotImplementedError(f"{cfg.name}: only the dense branch is ported to repro_torch")
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


def _block_fwd(bp: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
               return_cache: bool):
    """Pre-norm residual block. Returns (x, cache or None)."""
    h = apply_norm(x, bp["norm1"], cfg.norm, cfg.norm_eps)
    res = attn.attn_fwd(bp["mixer"], h, cfg, positions, return_cache=return_cache)
    out, cache = res if return_cache else (res, None)
    x = x + out
    h = apply_norm(x, bp["norm2"], cfg.norm, cfg.norm_eps)
    return x + _mlp_fwd(bp["mlp"], h, cfg), cache


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
    caches = []
    for g in range(layout.num_groups):
        gparams = map_leaves(lambda p: p[g], params["groups"])
        gcache = {}
        for i in range(len(layout.group)):
            x, c = _block_fwd(gparams[f"b{i}"], x, cfg, positions, return_cache)
            gcache[f"b{i}"] = c
        caches.append(gcache)
    logits = _logits(params, cfg, apply_norm(x, params["norm_f"], cfg.norm, cfg.norm_eps))
    out = (logits, _zero_aux(x.device))
    if return_cache:
        stacked = {
            b: {n: torch.stack([c[b][n] for c in caches]) for n in caches[0][b]}
            for b in caches[0]
        }
        out += ({"layers": stacked, "memory": None},)
    return out


def pad_cache(cache: dict, cfg: ModelConfig, max_len: int) -> dict:
    """Grow the stacked (groups, B, S, KV, D) K/V leaves to the decode
    cache length; ring buffers (SWA) never grow past the window."""
    target = attn.cache_len(cfg, max_len)
    layers = {}
    for b, leaves in cache["layers"].items():
        layers[b] = {}
        for n, val in leaves.items():
            s = val.shape[2]
            layers[b][n] = F.pad(val, (0, 0, 0, 0, 0, target - s)) if s < target else val
    return dict(cache, layers=layers)


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int | None = None):
    """Full-context forward returning last-position logits + decode cache."""
    logits, _, cache = forward(params, cfg, batch, return_cache=True)
    if max_len is not None:
        cache = pad_cache(cache, cfg, max_len)
    return logits[:, -1:], cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos: int):
    """One token for the whole batch. tokens: (B, 1). Returns (logits, cache).

    The cache's K/V leaves are updated in place: each group's slice is a
    view of the stacked leaf, and ``attn_decode`` writes into it.
    """
    layout = decoder_layout(cfg)
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    for g in range(layout.num_groups):
        gparams = map_leaves(lambda p: p[g], params["groups"])
        for i in range(len(layout.group)):
            bp, lc = gparams[f"b{i}"], cache["layers"][f"b{i}"]
            h = apply_norm(x, bp["norm1"], cfg.norm, cfg.norm_eps)
            out, _ = attn.attn_decode(bp["mixer"], h, {"k": lc["k"][g], "v": lc["v"][g]}, pos, cfg)
            x = x + out
            h = apply_norm(x, bp["norm2"], cfg.norm, cfg.norm_eps)
            x = x + _mlp_fwd(bp["mlp"], h, cfg)
    logits = _logits(params, cfg, apply_norm(x, params["norm_f"], cfg.norm, cfg.norm_eps))
    return logits, cache
