"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437).

Port of the reference's ``models/mla.py`` (its spec is ``spec.mla_spec``).
Queries and KV are low-rank compressed; only the compressed latent
(c_kv, kv_lora_rank) and the shared decoupled RoPE key (qk_rope_head_dim)
are cached at decode time: 576 values per token and layer for the
128-head config, against 2·128·128 for a cache of expanded K and V.

Full-sequence attention folds the (nope, rope) split into one query and
one key of head dim ``qk_nope + qk_rope`` (192 at full width) and pads V
with zeros to that head dim, as the reference does; scores are scaled by
that dim's ^-0.5 and the padding is sliced off after. On a CUDA tensor it
runs the flash kernel (B1, MHA: kv heads = heads); on the CPU the chunked
``blockwise_attention`` at ``cfg.q_chunk``, which is what the reference
calls whatever ``use_pallas`` says.

Decode uses the reference's matrix absorption: ``wk_b`` is folded into
the query (``q_lat = q_nope·wk_bᵀ``) and ``wv_b`` applied after the PV
product, so the latent is never expanded to per-head K/V. Contractions
run in the reference's order and in the promoted dtype of their operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .attention import blockwise_attention, einsum_promote, matmul_promote, project_in, project_out
from .layers import apply_rope, rms_norm


def _project_q(params: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    dn = cfg.mla.qk_nope_head_dim
    cq = rms_norm(matmul_promote(x, params["wq_a"]), params["q_norm"]["scale"], cfg.norm_eps)
    q = project_in(cq, params["wq_b"])  # (B, S, H, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _project_kv_latent(params: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    r = cfg.mla.kv_lora_rank
    ckv_rope = matmul_promote(x, params["wkv_a"])
    c_kv = rms_norm(ckv_rope[..., :r], params["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = apply_rope(ckv_rope[..., r:], positions, cfg.rope_theta)  # (B, S, dr) shared
    return c_kv, k_rope


def _pad_v(v: torch.Tensor, to_dim: int) -> torch.Tensor:
    """Zero-pad V's head dim so q/k/v share a head dim (trimmed after)."""
    pad = to_dim - v.shape[-1]
    return F.pad(v, (0, pad)) if pad > 0 else v


def mla_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, *,
            return_cache: bool = False):
    """Full-sequence MLA (training / prefill)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _project_q(params, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(params, x, cfg, positions)
    k_nope = project_in(c_kv, params["wk_b"])
    v = project_in(c_kv, params["wv_b"])
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    v_full = _pad_v(v, q_full.shape[-1])
    # head dims differ (qk 192 vs v 128 at full width): scaled by the qk dim
    if q_full.is_cuda:
        out = ops.flash_attention(q_full, k_full, v_full, causal=True)
    else:
        out = blockwise_attention(q_full, k_full, v_full, cfg.q_chunk)
    y = project_out(out[..., : m.v_head_dim], params["wo"])
    if return_cache:
        return y, {"c_kv": c_kv, "k_rope": k_rope}
    return y


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                   device: str | torch.device = "cpu") -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_decode(params: dict, x_t: torch.Tensor, cache: dict, pos: int,
               cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Absorbed decode of one token (x_t: (B, 1, d)): score and value paths
    stay in the latent space. Writes this token's latent and RoPE key into
    the cache tensors in place (the reference returns updated copies)."""
    m = cfg.mla
    pos_arr = torch.full((1,), pos, device=x_t.device)  # a fill: no host copy, no sync
    q_nope, q_rope = _project_q(params, x_t, cfg, pos_arr)  # (B, 1, H, dn / dr)
    c_t, kr_t = _project_kv_latent(params, x_t, cfg, pos_arr)

    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    ln = c_kv.shape[1]
    slot = min(pos, ln - 1)  # where dynamic_update_slice clamps the start
    c_kv[:, slot : slot + 1].copy_(c_t)
    k_rope[:, slot : slot + 1].copy_(kr_t)

    # absorption: q_lat[h] = q_nope[h] @ wk_b[:, h, :]^T, in the latent space
    q_lat = einsum_promote("bshk,rhk->bshr", q_nope, params["wk_b"])  # (B, 1, H, r)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (einsum_promote("bshr,btr->bhst", q_lat, c_kv)
              + einsum_promote("bshk,btk->bhst", q_rope, k_rope)).float() * scale
    valid = torch.arange(ln, device=x_t.device) <= pos
    scores = torch.where(valid, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    out_lat = einsum_promote("bhst,btr->bshr", probs, c_kv)  # (B, 1, H, r)
    out = einsum_promote("bshr,rhk->bshk", out_lat, params["wv_b"])  # absorb wv_b
    return project_out(out, params["wo"]), {"c_kv": c_kv, "k_rope": k_rope}
