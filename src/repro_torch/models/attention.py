"""GQA / sliding-window / cross attention with KV caching.

Port of the reference's ``models/attention.py``. Entry points:
  * ``attn_fwd``       — full-sequence prefill forward
  * ``cross_attn_fwd`` — attention over a memory (image patches, encoder
    output), tanh-gated
  * ``attn_decode``    — single-token decode against a cache

``attn_fwd`` and ``cross_attn_fwd`` on a CUDA tensor always run the
hand-written flash kernel (cross-attention bidirectional, with k/v of the
memory's length). On the CPU, ``attn_fwd``'s ``cfg.use_pallas`` picks the
kernel's plain twin (True) or the port of the chunked
``blockwise_attention`` (False), so each CPU path can be held against its
JAX counterpart; ``cross_attn_fwd`` follows the reference, which computes
it with ``gqa_scores_softmax_out`` whatever ``use_pallas`` says.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import apply_rope, causal_mask
from .sharding import grad_as_placed, shard_activation, split_sharded


def matmul_promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of both, as ``jnp.einsum`` does."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dtype), w.to(dtype))


def einsum_promote(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of both, as ``jnp.einsum`` does."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


def project_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"). A dry-run's DTensor product may come out
    sharded along h·k where the heads do not divide: ``split_sharded``
    replicates it before the heads are split off, and the flattened
    weight's gradient goes back in the weight's layout."""
    d, h, k = w.shape
    y = matmul_promote(x, grad_as_placed(w.reshape(d, h * k)))
    return split_sharded(y, -1, h).unflatten(-1, (h, k))


def project_out(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"). In a dry-run the flattened heads' gradient
    goes back in their forward layout (``grad_as_placed``)."""
    h, k, d = w.shape
    return matmul_promote(grad_as_placed(y.flatten(-2)), w.reshape(h * k, d))


def gqa_scores_softmax_out(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KV, D)
    v: torch.Tensor,  # (B, Skv, KV, D)
    mask: torch.Tensor | None,  # broadcastable to (B, KV, G, Sq, Skv) or (Sq, Skv)
) -> torch.Tensor:
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = split_sharded(q, 2, kv).reshape(b, sq, kv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * d**-0.5
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, d)


def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    q_chunk: int,
    window: int = 0,
    causal: bool = True,
    cfg=None,
) -> torch.Tensor:
    """Query-block chunked attention: each block of ``q_chunk`` queries
    against the full keys, masked; never the full (B,H,S,S) scores. With
    ``cfg``, each block and its output keep batch and heads sharded
    inside ``activation_mesh`` (the reference's constraints)."""
    b, s, h, d = q.shape
    if q_chunk <= 0 or s % q_chunk or s <= q_chunk:
        mask = causal_mask(s, s, window=window, device=q.device) if causal else None
        return gqa_scores_softmax_out(q, k, v, mask)
    outs = []
    axes = ("batch", "seq", "heads", None)
    for offset in range(0, s, q_chunk):
        m = causal_mask(q_chunk, s, q_offset=offset, window=window, device=q.device) if causal else None
        qi = q[:, offset : offset + q_chunk]
        if cfg is not None:
            qi = shard_activation(qi, axes, cfg)
        out_i = gqa_scores_softmax_out(qi, k, v, m)
        outs.append(out_i if cfg is None else shard_activation(out_i, axes, cfg))
    return torch.cat(outs, dim=1)


def project_qkv(params: dict, x: torch.Tensor, mem: torch.Tensor | None = None):
    """q from ``x``; k and v from ``mem`` when given (cross-attention), else from ``x``."""
    src = x if mem is None else mem
    q = project_in(x, params["wq"])
    k = project_in(src, params["wk"])
    v = project_in(src, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def attn_fwd(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,) or (B, S)
    *,
    return_cache: bool = False,
):
    q, k, v = project_qkv(params, x)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if ops.on_card(q) or cfg.use_pallas:
        out = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = blockwise_attention(q, k, v, cfg.q_chunk, window=cfg.sliding_window, causal=True,
                                  cfg=cfg)
    y = project_out(out, params["wo"])
    if return_cache:
        return y, make_cache_from_prefill(k, v, cfg)
    return y


def gate_out(params: dict, y: torch.Tensor) -> torch.Tensor:
    """The tanh-gated cross-attention residual: every cross-attention has a
    ``gate`` (llama-3.2-vision's gating in the reference), which starts at
    zero."""
    return torch.tanh(params["gate"].to(y.dtype)) * y if "gate" in params else y


def unmasked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Every query sees every key (cross-attention, the encoder): B1
    bidirectional on a CUDA tensor, with k/v of their own length; on the
    CPU the reference's ``gqa_scores_softmax_out``, which it uses whatever
    ``use_pallas`` says."""
    if ops.on_card(q):
        return ops.flash_attention(q, k, v, causal=False)
    return gqa_scores_softmax_out(q, k, v, None)


def cross_attn_fwd(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    memory: torch.Tensor,  # (B, M, mem_dim)
    cfg: ModelConfig,
) -> torch.Tensor:
    """Every query sees the whole memory: no mask, no RoPE."""
    q, k, v = project_qkv(params, x, mem=memory)
    return gate_out(params, project_out(unmasked_attention(q, k, v), params["wo"]))


# ---------------------------------------------------------------------------
# KV cache (contiguous, or ring buffer under sliding-window attention)
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """SWA bounds the live KV window — the decode cache is a ring buffer."""
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def abstract_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype) -> dict:
    """The decode cache's K/V as tensors on the meta device (no memory)."""
    shape = (batch, cache_len(cfg, max_len), cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


def make_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig) -> dict:
    """Prefill K/V -> decode cache. Under SWA, keep the last ``window``
    positions rotated into ring order (slot = position % window)."""
    s = k.shape[1]
    w = cfg.sliding_window
    if w > 0 and s > w:
        k = torch.roll(k[:, -w:], shifts=s % w, dims=1)
        v = torch.roll(v[:, -w:], shifts=s % w, dims=1)
    return {"k": k, "v": v}


def position_tensor(pos: int | torch.Tensor, device: torch.device) -> torch.Tensor:
    """A decode position, a Python int or a 0-dim integer tensor, as a
    (1,) int64 tensor on ``device``: a fill or a view, no host sync."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), pos, device=device)


def cache_slot(pos: int | torch.Tensor, ln: int, ring: bool) -> int | torch.Tensor:
    """The cache row a decode at ``pos`` writes: ``pos`` modulo ``ln`` in a
    ring buffer, else ``pos`` clamped to the last row (where
    dynamic_update_slice clamps the start). An int for an int position, so
    the host-bound decode loop pays no device op for it; a (1,) tensor for
    a tensor position, which never reaches the host."""
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(1).to(torch.int64)
        return torch.remainder(pos, ln) if ring else pos.clamp(max=ln - 1)
    return pos % ln if ring else min(pos, ln - 1)


def write_slot(cache: torch.Tensor, slot: int | torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, slot] = new`` in place, for an int or a (1,) ``slot``
    tensor (``cache_slot``'s). A DTensor cache is written shard by shard: DTensor has no
    ``index_copy_`` rule on every torch it runs on, and along a sharded
    sequence (dim 1) its rule leaves the shard and its placement
    disagreeing. ``new`` takes the cache's layout, whole along the
    sequence. Along a sharded sequence only the rank whose shard holds the
    slot takes ``new``; every other rank writes its own row back (one
    write of one shape on every rank, as a partitioner writes a dynamic
    update slice into a sharded dim)."""
    if not isinstance(cache, DTensor):
        if isinstance(slot, int):
            cache[:, slot : slot + 1].copy_(new)
        else:
            cache.index_copy_(1, slot, new.to(cache.dtype))
        return
    new = new.to(cache.dtype)
    if isinstance(slot, int):
        slot = torch.full((1,), slot, device=new.device)
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    placements = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                  for p in cache.placements]
    local = cache.to_local()
    local_slot = slot.to_local() if isinstance(slot, DTensor) else slot
    local_new = new.redistribute(cache.device_mesh, placements).to_local()
    rows = local.shape[1]
    if rows != cache.shape[1]:
        if rows == 0:
            return
        _, offset = compute_local_shape_and_global_offset(cache.shape, cache.device_mesh,
                                                          cache.placements)
        local_slot = local_slot - offset[1]
        owned = ((local_slot >= 0) & (local_slot < rows)).reshape((1,) * local_new.ndim)
        local_slot = local_slot.clamp(0, rows - 1)
        local_new = torch.where(owned, local_new, local.index_select(1, local_slot))
    local.index_copy_(1, local_slot, local_new)


def attn_decode(
    params: dict,
    x_t: torch.Tensor,  # (B, 1, d_model)
    cache: dict,
    pos: int | torch.Tensor,  # absolute position of this token: an int or a 0-dim tensor
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """One token against the cache. Writes this token's K/V into the cache
    tensors in place (the reference returns updated copies). For a tensor
    position the slot and the mask are tensor ops, so it never reaches
    the host; for an int they are host arithmetic."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(x_t.device)
    q, k_t, v_t = project_qkv(params, x_t)
    if cfg.use_rope:
        pos_arr = position_tensor(pos, x_t.device)
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k_t = apply_rope(k_t, pos_arr, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    ln = k.shape[1]
    ring = cfg.sliding_window > 0  # ring buffer — O(window) memory at any context length
    slot = cache_slot(pos, ln, ring)
    write_slot(k, slot, k_t)
    write_slot(v, slot, v_t)

    # Validity: ring slots written so far; contiguous cache positions <= pos.
    idx = torch.arange(ln, device=x_t.device)
    if isinstance(pos, torch.Tensor):
        valid = idx < (pos + 1).clamp(max=ln) if ring else idx <= pos
    else:
        valid = idx < min(pos + 1, ln) if ring else idx <= pos  # a ring is full once wrapped
    out = gqa_scores_softmax_out(q, k, v, valid[None, None, None, None, :])
    return project_out(out, params["wo"]), {"k": k, "v": v}
