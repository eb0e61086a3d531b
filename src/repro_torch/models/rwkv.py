"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free, O(1) state.

Port of the reference's ``models/rwkv.py``. Time-mix with a data-dependent
token shift (ddlerp) and a data-dependent per-channel decay
w_t = exp(-exp(w0 + lora(x_t))); channel-mix with a squared-ReLU MLP.

Prefill runs the chunked WKV. On a CUDA tensor it always goes through the
hand-written kernel (``kernels.ops.rwkv6_chunked``); on the CPU,
``cfg.use_pallas`` picks the kernel's plain twin (True) or the port of the
reference's XLA path, ``_wkv_chunked`` (False). Decode is the O(1)
recurrence, as in the reference, which has no decode kernel.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .attention import matmul_promote
from .layers import group_norm_heads, silu
from .sharding import shard_activation, split_sharded

_MIX_NAMES = ("r", "k", "v", "w", "g")


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    hs = cfg.rwkv.head_size
    return cfg.d_model // hs, hs


def wkv_chunk(t: int, chunk: int = 32) -> int:
    """The reference's chunk rule: ``min(chunk, T)``, shrunk until it
    divides T (so a prime T runs chunk 1)."""
    c = min(chunk, t)
    while t % c:
        c -= 1
    return c


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """Shift right by one along time; first slot filled by x_prev (decode state)."""
    if x_prev is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = x_prev[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(params: dict, x: torch.Tensor, xs: torch.Tensor) -> dict[str, torch.Tensor]:
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g)."""
    lm = params["mix_b"].shape[1]
    dx = xs - x
    xx = x + dx * params["mu_x"].to(x.dtype)
    lora = torch.tanh(matmul_promote(xx, params["mix_a"]))
    lora = split_sharded(lora, -1, 5).unflatten(-1, (5, lm))  # (B, T, 5, lm)
    dyn = torch.einsum("btnl,nld->btnd", lora, params["mix_b"].to(lora.dtype))  # (B, T, 5, d)
    out = {}
    for i, name in enumerate(_MIX_NAMES):
        mix = params["mu"][i].to(x.dtype) + dyn[:, :, i].to(x.dtype)
        out[name] = x + dx * mix
    return out


def _decay(params: dict, xw: torch.Tensor) -> torch.Tensor:
    """log(w_t) = -exp(w0 + tanh(xw A) B), clipped to (-12, 4) before the
    exp; shape (B, T, d), float32."""
    lora = matmul_promote(torch.tanh(matmul_promote(xw, params["w_a"])), params["w_b"])
    return -torch.exp(torch.clamp(params["w0"].float() + lora.float(), -12.0, 4.0))


def _wkv_chunked(
    r: torch.Tensor,  # (B, T, H, K) float32
    k: torch.Tensor,
    v: torch.Tensor,  # (B, T, H, V)
    logw: torch.Tensor,  # (B, T, H, K) float32, <= 0
    u: torch.Tensor,  # (H, K)
    s0: torch.Tensor,  # (B, H, K, V) float32
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Port of the reference's XLA path: the same chunked form on the
    model's (B, T, H, K) layout, with the scan over chunks as a loop."""
    bsz, t, h, dk = r.shape
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    tri = tri[None, :, :, None, None]
    s = s0
    outs = []
    for c0 in range(0, t, chunk):
        rk, kk, vk, lw = (x[:, c0 : c0 + chunk] for x in (r, k, v, logw))  # (B, c, H, K/V)
        cum = torch.cumsum(lw, dim=1)
        cum_prev = cum - lw  # cum up to t-1 (exclusive)
        diff = cum_prev[:, :, None] - cum[:, None, :]  # (B, c, c, H, K), <= 0 for s < t
        # exp of the masked difference: where(tri, exp(diff), 0) gives the
        # same bits, but its gradient is 0·inf = NaN once exp(diff) overflows
        # above the diagonal at strong decay (ROADMAP C13)
        ratio = torch.exp(torch.where(tri, diff, -torch.inf))
        scores = torch.einsum("bthk,bshk,btshk->bths", rk, kk, ratio)
        diag = torch.einsum("bthk,hk,bthk->bth", rk, u, kk)  # the bonus
        out = torch.einsum("bths,bshv->bthv", scores, vk)
        out = out + diag[..., None] * vk
        rw = rk * torch.exp(cum_prev)
        out = out + torch.einsum("bthk,bhkv->bthv", rw, s)
        tail = torch.exp(cum[:, -1:] - cum)  # (B, c, H, K)
        s = torch.exp(cum[:, -1])[..., None] * s + torch.einsum("bshk,bshv->bhkv", kk * tail, vk)
        outs.append(out)
    return torch.cat(outs, dim=1), s


def rwkv_time_mix_fwd(
    params: dict,
    x: torch.Tensor,  # (B, T, d)
    cfg: ModelConfig,
    *,
    chunk: int = 32,
    state: dict | None = None,
    return_cache: bool = False,
):
    bsz, t, d = x.shape
    h, hs = _heads(cfg)
    x_prev = state["x_prev"] if state is not None else None
    xs = _token_shift(x, x_prev)
    mixed = _ddlerp(params, x, xs)
    r = matmul_promote(mixed["r"], params["wr"])
    k = matmul_promote(mixed["k"], params["wk"])
    v = matmul_promote(mixed["v"], params["wv"])
    g = silu(matmul_promote(mixed["g"], params["wg"]))
    logw = _decay(params, mixed["w"])  # (B, T, d) float32
    # batch stays on (pod, data) and the channels on model through the WKV
    r, k, v, logw = (shard_activation(a, ("batch", "seq", "inner"), cfg) for a in (r, k, v, logw))

    def split_heads(a: torch.Tensor) -> torch.Tensor:
        return a.reshape(bsz, t, h, hs)

    rh, kh, vh = (split_heads(a).float() for a in (r, k, v))
    wh = split_heads(logw)
    u = params["u"].float().reshape(h, hs)
    c = wkv_chunk(t, chunk)
    if state is not None:
        s0 = state["wkv"]
    else:
        s0 = torch.zeros((bsz, h, hs, hs), dtype=torch.float32, device=x.device)
    if ops.on_card(rh) or cfg.use_pallas:
        out, s_final = ops.rwkv6_chunked(rh, kh, vh, wh, u, s0, chunk=c)
    else:
        out, s_final = _wkv_chunked(rh, kh, vh, wh, u, s0, c)
    out = group_norm_heads(out.to(x.dtype), params["ln_x"]["scale"], params["ln_x"]["bias"])
    y = matmul_promote(out * g, params["wo"])
    if return_cache:
        return y, {"wkv": s_final, "x_prev": x[:, -1]}
    return y


def rwkv_channel_mix_fwd(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: dict | None = None,
    return_cache: bool = False,
):
    x_prev = state["x_prev"] if state is not None else None
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * params["mu_k"].to(x.dtype)
    xr = x + (xs - x) * params["mu_r"].to(x.dtype)
    kk = torch.relu(matmul_promote(xk, params["wk"])).square()
    out = torch.sigmoid(matmul_promote(xr, params["wr"])) * matmul_promote(kk, params["wv"])
    if return_cache:
        return out, {"x_prev": x[:, -1]}
    return out


# ---------------------------------------------------------------------------
# Decode (single token, O(1) state)
# ---------------------------------------------------------------------------


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device: str | torch.device) -> dict:
    h, hs = _heads(cfg)
    d = cfg.d_model
    return {
        "tm": {"wkv": torch.zeros((batch, h, hs, hs), dtype=torch.float32, device=device),
               "x_prev": torch.zeros((batch, d), dtype=dtype, device=device)},
        "cm": {"x_prev": torch.zeros((batch, d), dtype=dtype, device=device)},
    }


def rwkv_time_mix_decode(params: dict, x_t: torch.Tensor, state: dict, cfg: ModelConfig):
    """x_t: (B, 1, d). The exact recurrence, no chunking.

    Updates ``state["wkv"]`` and ``state["x_prev"]`` in place (the
    reference returns new arrays) and returns them as the new state: in a
    stacked decode cache they are views of one layer's slice.
    """
    bsz, _, d = x_t.shape
    h, hs = _heads(cfg)
    xs = state["x_prev"][:, None, :].to(x_t.dtype)
    mixed = _ddlerp(params, x_t, xs)
    r, k, v = (matmul_promote(mixed[n], params[f"w{n}"]).reshape(bsz, h, hs).float()
               for n in ("r", "k", "v"))
    g = silu(matmul_promote(mixed["g"], params["wg"]))
    w = torch.exp(_decay(params, mixed["w"]))[:, 0].reshape(bsz, h, hs)  # (B, H, K)
    u = params["u"].float().reshape(h, hs)

    s = state["wkv"]  # (B, H, K, V)
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
    s.mul_(w[..., None]).add_(kv)
    state["x_prev"].copy_(x_t[:, -1])
    out = group_norm_heads(out.reshape(bsz, 1, h, hs).to(x_t.dtype),
                           params["ln_x"]["scale"], params["ln_x"]["bias"])
    y = matmul_promote(out * g, params["wo"])
    return y, {"wkv": s, "x_prev": state["x_prev"]}


def rwkv_channel_mix_decode(params: dict, x_t: torch.Tensor, state: dict, cfg: ModelConfig):
    """One token; updates ``state["x_prev"]`` in place, as the time mix does."""
    y = rwkv_channel_mix_fwd(params, x_t, cfg, state=state)
    state["x_prev"].copy_(x_t[:, -1])
    return y, {"x_prev": state["x_prev"]}
