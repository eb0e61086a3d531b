"""Mamba-1 selective SSM block (jamba's sequence mixer, arXiv:2403.19887).

Port of the reference's ``models/ssm.py``. Prefill runs the selective
scan through ``kernels.ops.mamba_chunk_scan``: the hand-written kernel on
a CUDA tensor, its plain twin on the CPU, whatever ``cfg.use_pallas``
says. Decode is the O(1) state update, as in the reference, which has no
decode kernel.

Jamba-style extras: RMS norms on the dt/B/C projections.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .attention import matmul_promote
from .layers import rms_norm, silu, softplus


def d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba.expand * cfg.d_model


def scan_chunk(t: int, chunk: int = 64) -> int:
    """The reference's chunk rule: ``min(chunk, T)``, shrunk until it
    divides T (T=300 runs 60, 200 runs 50, a prime T runs 1)."""
    c = min(chunk, t)
    while t % c:
        c -= 1
    return c


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, T, di), w: (cw, di), state:
    (B, cw-1, di). Sums the shifted products in the reference's order."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+cw-1, di)
    t = x.shape[1]
    out = sum(xp[:, i : i + t] * w[i] for i in range(cw))
    new_state = xp[:, -(cw - 1):] if cw > 1 else torch.zeros_like(pad)
    return out + b, new_state


def _ssm_inputs(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Project to (dt, B, C) with jamba's norms; returns float32 scan
    operands (dt, B, C, A)."""
    n, r = cfg.mamba.state_dim, cfg.mamba.dt_rank
    dbc = matmul_promote(x, params["x_proj"])
    dt, b_mat, c_mat = torch.split(dbc, [r, n, n], dim=-1)
    dt = rms_norm(dt, params["dt_norm"]["scale"], cfg.norm_eps)
    b_mat = rms_norm(b_mat, params["b_norm"]["scale"], cfg.norm_eps)
    c_mat = rms_norm(c_mat, params["c_norm"]["scale"], cfg.norm_eps)
    dt = softplus(matmul_promote(dt, params["dt_w"]).float() + params["dt_b"].float())
    a = -torch.exp(params["a_log"].float())  # (di, n)
    return dt, b_mat.float(), c_mat.float(), a


def mamba_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, *, chunk: int = 64,
              return_cache: bool = False):
    """x: (B, T, d) -> (B, T, d)[, cache {"h", "conv"}]."""
    bsz, t, _ = x.shape
    xz = matmul_promote(x, params["in_proj"])
    xin, z = xz.chunk(2, dim=-1)
    xin, conv_state = _conv1d_causal(xin, params["conv_w"], params["conv_b"], None)
    xin = silu(xin)
    dt, b_mat, c_mat, a = _ssm_inputs(params, xin, cfg)
    c = scan_chunk(t, chunk)
    h0 = torch.zeros((bsz, d_inner(cfg), a.shape[1]), dtype=torch.float32, device=x.device)
    y, h = ops.mamba_chunk_scan(dt, b_mat, c_mat, a, xin, h0, chunk=c)
    y = y + params["d_skip"].float() * xin.float()
    y = y.to(x.dtype) * silu(z)
    out = matmul_promote(y, params["out_proj"])
    if return_cache:
        return out, {"h": h, "conv": conv_state}
    return out


# ---------------------------------------------------------------------------
# Decode (single token, O(1) state)
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: str | torch.device) -> dict:
    di = d_inner(cfg)
    return {
        "h": torch.zeros((batch, di, cfg.mamba.state_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.mamba.conv_width - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(params: dict, x_t: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x_t: (B, 1, d). The exact recurrence for one step.

    Updates ``cache["h"]`` and ``cache["conv"]`` in place (the reference
    returns new arrays) and returns them as the new cache: in a stacked
    decode cache they are views of one layer's slice.
    """
    xz = matmul_promote(x_t, params["in_proj"])
    xin, z = xz.chunk(2, dim=-1)
    xin, conv_state = _conv1d_causal(xin, params["conv_w"], params["conv_b"], cache["conv"])
    xin = silu(xin)
    dt, b_mat, c_mat, a = _ssm_inputs(params, xin, cfg)
    da = torch.exp(dt[:, 0, :, None] * a)  # (B, di, n); t == 1
    dbx = (dt * xin.float())[:, 0, :, None] * b_mat[:, 0, None, :]
    h = cache["h"].mul_(da).add_(dbx)
    y = torch.einsum("bdn,btn->btd", h, c_mat)
    y = y + params["d_skip"].float() * xin.float()
    y = y.to(x_t.dtype) * silu(z)
    cache["conv"].copy_(conv_state)
    return matmul_promote(y, params["out_proj"]), {"h": h, "conv": cache["conv"]}
