"""Model assembly: forward, prefill and decode.

Port of the reference's ``models/model.py`` for all ten architectures:
dense decoder-only models (stablelm, granite, starcoder2, qwen2.5), a group of
one ``[attn + mlp]`` block; MoE models (mixtral), a group of one
``[attn + moe]`` block; llama-3.2-vision, a group of one tanh-gated
cross-attention block over the image embeddings (``xattn``) and
``cross_attn_every - 1`` ``[attn + mlp]`` blocks; seamless-m4t, a
bidirectional encoder stack over projected source frames (``_encode``)
and a decoder of ``[attn + cross-attn + mlp]`` blocks (``attn_x``) over
its output; deepseek-v3, a group of one ``[mla + moe]`` block
behind a stack of ``dense_prefix_layers`` ``[mla + mlp]`` blocks
(``prefix_layout`` under ``prefix_cfg``: the MLP ``prefix_d_ff`` wide, no
experts), with a multi-token-prediction block (``mtp_logits``); RWKV-6, a
group of one ``[time-mix + channel-mix]`` block, each tiled
``num_layers`` times; and the jamba hybrid, a group of ``hybrid_period``
blocks (attention at ``hybrid_attn_index``, Mamba elsewhere; experts in
place of the dense MLP on every block with ``i % moe_every == 1``, or
none without experts) tiled ``num_layers / hybrid_period`` times.
Parameters keep the reference's stacked ``(num_groups, ...)`` leaves so
converted weights map one to one; the groups run in a Python loop, the
prefix stack's before the main stack's, each with a cache of its own
(``prefix_layers``, ``layers``); the memory the cross-attention reads
(image embeddings or the encoder's output) is the cache's ``memory``, and
each cross-attention block caches its K/V over it (``xk``, ``xv``), which
decode reads and ``pad_cache`` never grows. Each MoE block's load-balance and z
losses are summed over the blocks of a group, then over the groups, in
the reference's order; the prefix has no experts and adds none. Under
grad each group (the prefix's too; not the MTP block, as in the
reference) runs inside a non-reentrant ``torch.utils.checkpoint`` as the
reference wraps its scan body in ``jax.checkpoint``: with ``cfg.remat ==
"full"`` it is recomputed whole in the backward pass, with ``"dots"`` the
outputs of the products without batch dimensions (``mm``, ``addmm``) are
saved and the rest recomputed. ``abstract_cache`` gives the structure of
prefill's cache as tensors on the meta device, for the dry-run's cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig, MoEConfig
from ..tree import map_leaves
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .layers import activate, apply_norm, apply_rope

# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockDef:
    mixer: str  # attn | attn_x | xattn | mla | rwkv | mamba
    mlp: str  # dense | moe | rwkv_cm
    causal: bool = True  # False: the encoder's bidirectional attention


@dataclass(frozen=True)
class Layout:
    group: tuple[BlockDef, ...]
    num_groups: int

    @property
    def num_layers(self) -> int:
        return len(self.group) * self.num_groups


def mixer_of(cfg: ModelConfig) -> str:
    return "mla" if cfg.attention == "mla" else "attn"


def decoder_layout(cfg: ModelConfig) -> Layout:
    """The reference's decoder layout. A dense decoder with experts on
    every ``moe_every``-th block only (no config of either package has one)
    is not ported."""
    moe_on = cfg.moe.num_experts > 0
    if cfg.family == "ssm":
        return Layout((BlockDef("rwkv", "rwkv_cm"),), cfg.num_layers)
    if cfg.hybrid_period > 0:  # jamba
        blocks = tuple(
            BlockDef("attn" if i == cfg.hybrid_attn_index else "mamba",
                     "moe" if moe_on and i % cfg.moe.moe_every == 1 else "dense")
            for i in range(cfg.hybrid_period)
        )
        return Layout(blocks, cfg.num_layers // cfg.hybrid_period)
    if cfg.cross_attn_every > 0:  # llama-3.2-vision: a cross-attention layer opens each group
        blocks = (BlockDef("xattn", "dense"),) + (BlockDef("attn", "dense"),) * (
            cfg.cross_attn_every - 1)
        return Layout(blocks, cfg.num_layers // cfg.cross_attn_every)
    if moe_on and cfg.moe.moe_every > 1:
        raise NotImplementedError(
            f"{cfg.name}: a dense decoder with experts on every {cfg.moe.moe_every}th block "
            f"is not ported to repro_torch")
    return Layout((BlockDef(mixer_of(cfg), "moe" if moe_on else "dense"),), cfg.num_layers)


def encoder_layout(cfg: ModelConfig) -> Layout:
    return Layout((BlockDef("attn", "dense", causal=False),), cfg.encoder_layers)


def decoder_with_cross_layout(cfg: ModelConfig) -> Layout:
    """Seamless decoder: self-attn + cross-attn + mlp per layer."""
    return Layout((BlockDef("attn_x", "dense"),), cfg.num_layers)


def main_layout(cfg: ModelConfig) -> Layout:
    """The stack ``params["groups"]`` holds."""
    return decoder_with_cross_layout(cfg) if cfg.is_encdec else decoder_layout(cfg)


def prefix_layout(cfg: ModelConfig) -> Layout:
    """Dense-MLP prefix layers (deepseek: first 3 of 61)."""
    return Layout((BlockDef(mixer_of(cfg), "dense"),), cfg.dense_prefix_layers)


def prefix_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.copy(d_ff=cfg.prefix_d_ff or cfg.d_ff, moe=MoEConfig())


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


def _bidir_attn(params: dict, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The encoder's self-attention: RoPE (whatever ``cfg.use_rope`` says,
    as the reference), no mask."""
    q, k, v = attn.project_qkv(params, h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return attn.project_out(attn.unmasked_attention(q, k, v), params["wo"])


def _cross_cache(params: dict, memory: torch.Tensor) -> dict:
    """K/V of the memory, which every decode step reads. Without ``bk``/``bv``,
    as the reference builds them (ROADMAP C20)."""
    return {"xk": attn.project_in(memory, params["wk"]),
            "xv": attn.project_in(memory, params["wv"])}


def _block_fwd(bdef: BlockDef, bp: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, return_cache: bool, memory: torch.Tensor | None = None):
    """Pre-norm residual block. Returns (x, aux or None, cache or None):
    an MoE block's aux holds its ``lb_loss`` and ``z_loss``; the cache
    holds the mixer's leaves (a cross-attention's ``xk``/``xv``) and, for
    the channel mix, ``{"cm": ...}``."""
    h = apply_norm(x, bp["norm1"], cfg.norm, cfg.norm_eps)
    if bdef.mixer in ("attn", "attn_x") and not bdef.causal:  # the encoder: no decode cache
        res = _bidir_attn(bp["mixer"], h, cfg, positions)
    elif bdef.mixer in ("attn", "attn_x"):
        res = attn.attn_fwd(bp["mixer"], h, cfg, positions, return_cache=return_cache)
    elif bdef.mixer == "xattn":
        res = attn.cross_attn_fwd(bp["mixer"], h, memory, cfg)
        res = (res, _cross_cache(bp["mixer"], memory)) if return_cache else res
    elif bdef.mixer == "mla":
        res = mla_mod.mla_fwd(bp["mixer"], h, cfg, positions, return_cache=return_cache)
    elif bdef.mixer == "rwkv":
        res = rwkv_mod.rwkv_time_mix_fwd(bp["mixer"], h, cfg, return_cache=return_cache)
    elif bdef.mixer == "mamba":
        res = ssm_mod.mamba_fwd(bp["mixer"], h, cfg, return_cache=return_cache)
    else:
        raise ValueError(bdef.mixer)
    out, cache = res if return_cache else (res, None)
    x = x + out
    if bdef.mixer == "attn_x":  # seamless decoder: the cross-attention sub-layer
        h = apply_norm(x, bp["norm_x"], cfg.norm, cfg.norm_eps)
        x = x + attn.cross_attn_fwd(bp["xattn"], h, memory, cfg)
        if return_cache:
            cache.update(_cross_cache(bp["xattn"], memory))
    h = apply_norm(x, bp["norm2"], cfg.norm, cfg.norm_eps)
    if bdef.mlp == "dense":
        return x + _mlp_fwd(bp["mlp"], h, cfg), None, cache
    if bdef.mlp == "moe":
        out, aux = moe_mod.moe_fwd(bp["mlp"], h, cfg)
        return x + out, {"lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"]}, cache
    if bdef.mlp != "rwkv_cm":
        raise ValueError(bdef.mlp)
    res = rwkv_mod.rwkv_channel_mix_fwd(bp["mlp"], h, cfg, return_cache=return_cache)
    if not return_cache:
        return x + res, None, None
    out, cm = res
    return x + out, None, dict(cache, cm=cm)


def _group_fwd(layout: Layout, gparams: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, return_cache: bool,
               memory: torch.Tensor | None) -> tuple[torch.Tensor, dict, dict]:
    """Returns (x, the MoE blocks' summed aux or None, the group's cache)."""
    gcache = {}
    aux_sum = None
    for i, bdef in enumerate(layout.group):
        x, aux, gcache[f"b{i}"] = _block_fwd(bdef, gparams[f"b{i}"], x, cfg, positions,
                                             return_cache, memory)
        aux_sum = _add_aux(aux_sum, aux)
    return x, aux_sum, gcache


def _add_aux(a: dict | None, b: dict | None) -> dict | None:
    """Sum of two aux dicts, None standing for zeros. The reference starts
    its sums at 0.0; leaving the zeros out gives the same bits."""
    if a is None or b is None:
        return b if a is None else a
    return {k: a[k] + b[k] for k in a}


# remat "dots": the reference's ``checkpoint_dots_with_no_batch_dims`` saves
# the outputs of products without batch dimensions, which here reach the
# dispatcher as ``mm``/``addmm``; ``bmm`` (attention, the experts), the
# elementwise work and the kernels' autograd Functions are recomputed
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_groups(cfg: ModelConfig):
    """How to recompute each group in the backward pass, as the
    reference's ``jax.checkpoint`` around its scan body does: None (keep
    every activation), or the ``checkpoint`` keywords of the policy. Only
    under grad: serving (``inference_mode``) runs every group once either
    way."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r} (none | full | dots)")
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return None
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, _dots_policy)
    return kw


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return attn.matmul_promote(x, head).to(dtype_of(cfg.logits_dtype))


def _zero_aux(device: torch.device) -> dict:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": zero, "z_loss": zero.clone()}


def _run_stack(layout: Layout, groups_params: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, return_cache: bool, memory: torch.Tensor | None = None):
    """The groups of one stack in order, each reading ``memory`` when it
    cross-attends. Returns (x, the summed aux or None, the caches stacked
    (num_groups, ...) or None)."""
    remat = None if return_cache else _remat_groups(cfg)
    # one view per group of every stacked leaf: under grad, unbind's backward
    # stacks the groups' gradients once, where indexing would add a zero-filled
    # gradient of the whole stacked leaf for every group
    groups = map_leaves(lambda p: p.unbind(0), groups_params)
    aux = None
    caches = []
    for g in range(layout.num_groups):
        gparams = map_leaves(lambda views: views[g], groups)
        if remat is not None:
            x, gaux = checkpoint(
                lambda x, gp, mem: _group_fwd(layout, gp, x, cfg, positions, False, mem)[:2],
                x, gparams, memory, **remat)
        else:
            x, gaux, gcache = _group_fwd(layout, gparams, x, cfg, positions, return_cache,
                                         memory)
            caches.append(gcache)
        aux = _add_aux(aux, gaux)
    stacked = map_leaves(lambda *leaves: torch.stack(leaves), *caches) if return_cache else None
    return x, aux, stacked


def _encode(params: dict, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """seamless: project the source frames, run the bidirectional encoder
    stack, normalise."""
    enc = params["encoder"]
    x = attn.matmul_promote(frames, enc["proj"])
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = _run_stack(encoder_layout(cfg), enc["groups"], x, cfg, positions, False)
    return apply_norm(x, enc["norm_f"], cfg.norm, cfg.norm_eps)


def _memory_from_batch(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor | None:
    """What the cross-attention reads: the encoder's output over
    ``src_frames`` (seamless), or ``image_embeds`` as they are (llama-3.2-
    vision), in the compute dtype; None for a model without one. A missing
    key raises ``ValueError`` naming it (the reference raises a bare
    ``KeyError``; ROADMAP C19)."""
    key = "src_frames" if cfg.is_encdec else "image_embeds" if cfg.cross_attn_every > 0 else None
    if key is None:
        return None
    if key not in batch:
        raise ValueError(f"{cfg.name} cross-attends to a memory: the batch needs {key!r} "
                         f"(ServeEngine.generate(..., extras={{{key!r}: ...}}))")
    mem = batch[key].to(dtype_of(cfg.compute_dtype))
    return _encode(params, cfg, mem) if cfg.is_encdec else mem


def forward(params: dict, cfg: ModelConfig, batch: dict, *, return_cache: bool = False,
            return_hidden: bool = False):
    """Full-sequence forward. batch: {"tokens": (B, S) integer tensor}, and
    the memory the cross-attention reads: ``image_embeds`` (B, M,
    vision_embed_dim) for llama-3.2-vision, ``src_frames`` (B, M,
    audio_embed_dim) for seamless.

    Returns (logits, aux[, cache][, hidden]); aux holds the MoE blocks'
    summed ``lb_loss`` and ``z_loss`` (zeros without experts); cache leaves
    are stacked (num_groups, ...), the dense prefix's under
    ``prefix_layers``, and ``memory`` holds the cross-attention's memory
    (None without one); hidden is the final norm's output, which
    ``mtp_logits`` takes.
    """
    tokens = batch["tokens"].long()
    x = params["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    positions = torch.arange(tokens.shape[1], device=x.device)
    memory = _memory_from_batch(params, cfg, batch)
    if cfg.dense_prefix_layers > 0:
        x, _, prefix_caches = _run_stack(prefix_layout(cfg), params["prefix_groups"], x,
                                         prefix_cfg(cfg), positions, return_cache)
    x, aux, caches = _run_stack(main_layout(cfg), params["groups"], x, cfg, positions,
                                return_cache, memory)
    hidden = apply_norm(x, params["norm_f"], cfg.norm, cfg.norm_eps)
    out = (_logits(params, cfg, hidden), aux if aux is not None else _zero_aux(x.device))
    if return_cache:
        cache = {"layers": caches, "memory": memory}
        if cfg.dense_prefix_layers > 0:
            cache["prefix_layers"] = prefix_caches
        out += (cache,)
    if return_hidden:
        out += (hidden,)
    return out


def mtp_logits(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """DeepSeek MTP: predict token t+2 from (hidden_t, embed(token_{t+1})).
    Returns (B, S-1, V) logits, aligned with the targets t+2."""
    mtp = params["mtp"]
    h = hidden[:, :-1]  # positions 0..S-2
    nxt = params["embed"][tokens[:, 1:].long()].to(h.dtype)  # embed of t+1
    both = torch.cat([apply_norm(h, mtp["norm_in"], cfg.norm, cfg.norm_eps), nxt], dim=-1)
    x = attn.matmul_promote(both, mtp["proj"])
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = _block_fwd(BlockDef(mixer_of(cfg), "dense"), mtp["block"], x, cfg, positions, False)
    return _logits(params, cfg, x)


_SEQ_CACHE_KEYS = ("k", "v", "c_kv", "k_rope")  # leaves with a seq axis at dim 2


def pad_cache(cache: dict, cfg: ModelConfig, max_len: int) -> dict:
    """Grow the sequence-indexed leaves, stacked (groups, B, S, ...), to the
    decode cache length. State leaves (RWKV's ``wkv`` and ``x_prev``,
    Mamba's ``h`` and ``conv``), the cross-attention's ``xk``/``xv`` and the
    ``memory`` keep their length; ring buffers (SWA) never grow past the
    window."""
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

    new = dict(cache, layers=walk(cache["layers"]))
    if "prefix_layers" in cache:
        new["prefix_layers"] = walk(cache["prefix_layers"])
    return new


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int | None = None):
    """Full-context forward returning last-position logits + decode cache."""
    logits, _, cache = forward(params, cfg, batch, return_cache=True)
    if max_len is not None:
        cache = pad_cache(cache, cfg, max_len)
    return logits[:, -1:], cache


def _block_abstract_cache(bdef: BlockDef, cfg: ModelConfig, batch: int, max_len: int,
                          dtype: torch.dtype, mem_len: int) -> dict:
    cache: dict = {}
    if bdef.mixer in ("attn", "attn_x"):
        cache.update(attn.abstract_attn_cache(cfg, batch, max_len, dtype))
    if bdef.mixer in ("xattn", "attn_x"):
        shape = (batch, mem_len, cfg.num_kv_heads, cfg.head_dim)
        cache["xk"] = torch.empty(shape, dtype=dtype, device="meta")
        cache["xv"] = torch.empty(shape, dtype=dtype, device="meta")
    if bdef.mixer == "mla":
        cache.update(mla_mod.init_mla_cache(cfg, batch, max_len, dtype, "meta"))
    if bdef.mixer == "mamba":
        cache.update(ssm_mod.init_mamba_cache(cfg, batch, dtype, "meta"))
    if bdef.mixer == "rwkv":
        cache.update(rwkv_mod.init_rwkv_cache(cfg, batch, dtype, "meta")["tm"])
    if bdef.mlp == "rwkv_cm":
        cache["cm"] = {"x_prev": torch.empty((batch, cfg.d_model), dtype=dtype, device="meta")}
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, mem_len: int = 0) -> dict:
    """The cache ``prefill(..., max_len)`` returns for ``batch`` sequences
    (and a memory of ``mem_len`` rows), as tensors on the meta device in
    the compute dtype (Mamba's ``h`` and RWKV's ``wkv`` in float32): the
    same paths, shapes and dtypes, no memory. ``memory`` is None for a
    model without cross-attention."""
    dtype = dtype_of(cfg.compute_dtype)

    def group_stack(layout: Layout) -> dict:
        gc = {f"b{i}": _block_abstract_cache(b, cfg, batch, max_len, dtype, mem_len)
              for i, b in enumerate(layout.group)}
        return map_leaves(lambda t: torch.empty((layout.num_groups, *t.shape), dtype=t.dtype,
                                                device="meta"), gc)

    out = {"layers": group_stack(main_layout(cfg)), "memory": None}
    if cfg.dense_prefix_layers > 0:
        out["prefix_layers"] = group_stack(prefix_layout(cfg))
    if cfg.is_encdec or cfg.cross_attn_every > 0:
        mdim = cfg.d_model if cfg.is_encdec else cfg.vision_embed_dim
        out["memory"] = torch.empty((batch, mem_len, mdim), dtype=dtype, device="meta")
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _block_decode(bdef: BlockDef, bp: dict, x: torch.Tensor, cache: dict, pos: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """One token through one block. ``cache`` holds views of this layer's
    slice of the stacked cache; every mixer writes into them in place."""
    h = apply_norm(x, bp["norm1"], cfg.norm, cfg.norm_eps)
    if bdef.mixer in ("attn", "attn_x"):
        out, _ = attn.attn_decode(bp["mixer"], h, {"k": cache["k"], "v": cache["v"]}, pos, cfg)
    elif bdef.mixer == "xattn":
        out = _xattn_decode(bp["mixer"], h, cache)
    elif bdef.mixer == "mla":
        out, _ = mla_mod.mla_decode(
            bp["mixer"], h, {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]}, pos, cfg)
    elif bdef.mixer == "rwkv":
        out, _ = rwkv_mod.rwkv_time_mix_decode(
            bp["mixer"], h, {"wkv": cache["wkv"], "x_prev": cache["x_prev"]}, cfg)
    elif bdef.mixer == "mamba":
        out, _ = ssm_mod.mamba_decode(bp["mixer"], h, {"h": cache["h"], "conv": cache["conv"]}, cfg)
    else:
        raise ValueError(bdef.mixer)
    x = x + out
    if bdef.mixer == "attn_x":
        h = apply_norm(x, bp["norm_x"], cfg.norm, cfg.norm_eps)
        x = x + _xattn_decode(bp["xattn"], h, cache)
    h = apply_norm(x, bp["norm2"], cfg.norm, cfg.norm_eps)
    if bdef.mlp == "dense":
        return x + _mlp_fwd(bp["mlp"], h, cfg)
    if bdef.mlp == "moe":  # one token per sequence: a group of B tokens (C16)
        out, _ = moe_mod.moe_fwd(bp["mlp"], h, cfg)
        return x + out
    if bdef.mlp != "rwkv_cm":
        raise ValueError(bdef.mlp)
    out, _ = rwkv_mod.rwkv_channel_mix_decode(bp["mlp"], h, cache["cm"], cfg)
    return x + out


def _xattn_decode(params: dict, h: torch.Tensor, cache: dict) -> torch.Tensor:
    """One token against the cached memory K/V, in plain torch (the
    reference has no decode kernel); ``bq`` added, ``bk``/``bv`` never
    (ROADMAP C20)."""
    q = attn.project_in(h, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    out = attn.gqa_scores_softmax_out(q, cache["xk"], cache["xv"], None)
    return attn.gate_out(params, attn.project_out(out, params["wo"]))


def _decode_stack(layout: Layout, groups_params: dict, layer_caches: dict, x: torch.Tensor,
                  pos: int, cfg: ModelConfig) -> torch.Tensor:
    for g in range(layout.num_groups):
        gparams = map_leaves(lambda p: p[g], groups_params)
        for i, bdef in enumerate(layout.group):
            lcache = map_leaves(lambda c: c[g], layer_caches[f"b{i}"])
            x = _block_decode(bdef, gparams[f"b{i}"], x, lcache, pos, cfg)
    return x


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, pos: int):
    """One token for the whole batch. tokens: (B, 1). Returns (logits, cache).

    Unlike the reference's pure step, this one writes the cache it is
    given and returns that same object: each group's slice is a view of
    the stacked leaves, and the mixers write into it (a step captured in a
    CUDA graph needs that). So a second step from the same cache reads the
    first one's update; a caller that branches two decodes off one cache
    clones it first, ``map_leaves(torch.clone, cache)`` (ROADMAP C21). The
    dense prefix runs first, on its own ``prefix_layers``.
    """
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    if cfg.dense_prefix_layers > 0:
        x = _decode_stack(prefix_layout(cfg), params["prefix_groups"], cache["prefix_layers"], x,
                          pos, prefix_cfg(cfg))
    x = _decode_stack(main_layout(cfg), params["groups"], cache["layers"], x, pos, cfg)
    logits = _logits(params, cfg, apply_norm(x, params["norm_f"], cfg.norm, cfg.norm_eps))
    return logits, cache
