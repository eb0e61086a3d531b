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

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import apply_rope, causal_mask


def matmul_promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of both, as ``jnp.einsum`` does."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dtype), w.to(dtype))


def einsum_promote(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of both, as ``jnp.einsum`` does."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


def project_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk")."""
    d, h, k = w.shape
    return matmul_promote(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_out(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = w.shape
    return matmul_promote(y.flatten(-2), w.reshape(h * k, d))


def gqa_scores_softmax_out(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KV, D)
    v: torch.Tensor,  # (B, Skv, KV, D)
    mask: torch.Tensor | None,  # broadcastable to (B, KV, G, Sq, Skv) or (Sq, Skv)
) -> torch.Tensor:
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d)
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
) -> torch.Tensor:
    """Query-block chunked attention: each block of ``q_chunk`` queries
    against the full keys, masked; never the full (B,H,S,S) scores."""
    b, s, h, d = q.shape
    if q_chunk <= 0 or s % q_chunk or s <= q_chunk:
        mask = causal_mask(s, s, window=window, device=q.device) if causal else None
        return gqa_scores_softmax_out(q, k, v, mask)
    outs = []
    for offset in range(0, s, q_chunk):
        m = causal_mask(q_chunk, s, q_offset=offset, window=window, device=q.device) if causal else None
        outs.append(gqa_scores_softmax_out(q[:, offset : offset + q_chunk], k, v, m))
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
    if q.is_cuda or cfg.use_pallas:
        out = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = blockwise_attention(q, k, v, cfg.q_chunk, window=cfg.sliding_window, causal=True)
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
    if q.is_cuda:
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


def attn_decode(
    params: dict,
    x_t: torch.Tensor,  # (B, 1, d_model)
    cache: dict,
    pos: int,  # absolute position of this token
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """One token against the cache. Writes this token's K/V into the cache
    tensors in place (the reference returns updated copies)."""
    q, k_t, v_t = project_qkv(params, x_t)
    if cfg.use_rope:
        pos_arr = torch.full((1,), pos, device=x_t.device)  # a fill: no host copy, no sync
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k_t = apply_rope(k_t, pos_arr, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    ln = k.shape[1]
    if cfg.sliding_window > 0:
        slot = pos % ln  # ring buffer — O(window) memory at any context length
    else:
        slot = min(pos, ln - 1)
    k[:, slot : slot + 1].copy_(k_t)
    v[:, slot : slot + 1].copy_(v_t)

    # Validity: ring slots written so far; contiguous cache positions <= pos.
    idx = torch.arange(ln, device=x_t.device)
    if cfg.sliding_window > 0:
        valid = idx < min(pos + 1, ln)  # ring fully valid once wrapped
    else:
        valid = idx <= pos
    out = gqa_scores_softmax_out(q, k, v, valid[None, None, None, None, :])
    return project_out(out, params["wo"]), {"k": k, "v": v}
