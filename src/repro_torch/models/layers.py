"""Shared primitive layers: norms, activations, rotary embeddings.

Port of the reference's ``models/layers.py``. Norms and RoPE compute in
float32 and cast back to the input's dtype, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(dtype)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the channel dim (RWKV time-mix output).

    x: (..., H, D); scale/bias: (H*D,). Returns (..., H*D) in x's dtype.
    """
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = ((x - mu) * torch.rsqrt(var + eps)).flatten(-2)
    return (out * scale.float() + bias.float()).to(dtype)


def apply_norm(x: torch.Tensor, params: dict, kind: str, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, params["scale"], params["bias"], eps)
    return rms_norm(x, params["scale"], eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``. torch's ``F.softplus``
    returns x itself above 20, which differs by up to 2e-9 in float32."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch defaults to erf.
    return F.gelu(x, approximate="tanh")


def activate(gate: torch.Tensor, up: torch.Tensor | None, kind: str) -> torch.Tensor:
    """Gated (swiglu/geglu) or plain (gelu) MLP nonlinearity."""
    if kind == "swiglu":
        assert up is not None
        return silu(gate) * up
    if kind == "geglu":
        assert up is not None
        return gelu(gate) * up
    return gelu(gate)


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies for the rotated half of the head dim."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (B, S, H, D) (or (B, S, D) for shared keys) by position.

    positions: (B, S) or (S,) integers. Half-split rotation in float32.
    """
    inv = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    angles = positions.float()[..., None] * inv  # (..., S, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    if x.ndim == 4:  # (B, S, H, D) — broadcast over heads
        sin = sin[..., None, :]
        cos = cos[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask(
    q_len: int, kv_len: int, q_offset: int = 0, window: int = 0,
    device: torch.device | None = None,
) -> torch.Tensor:
    """(q_len, kv_len) boolean mask; True = attendable.

    ``q_offset`` is the absolute position of query 0; ``window`` > 0
    restricts to a sliding window.
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = kv_pos <= q_pos
    if window > 0:
        mask = mask & (kv_pos > q_pos - window)
    return mask
