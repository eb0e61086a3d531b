"""The dense family: StableLM's block (pre-norm LayerNorm with bias,
multi-head or grouped attention with rotary embeddings over the whole
head, a SwiGLU MLP), its parameter layout in the port's names, and what
the family adds to the shared rules of ``colonybench.weights``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import models

EPS_KEY = "layer_norm_eps"
ATTENTION = True  # q·k and p·v count in the model FLOPs


def layout(cfg: dict) -> dict:
    """One stacked block's shapes, keys in the port's names."""
    d, layers, f = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    return {
        "norm1": {"scale": (layers, d), "bias": (layers, d)},
        "mixer": {"wq": (layers, d, h, hd), "wk": (layers, d, kv, hd),
                  "wv": (layers, d, kv, hd), "wo": (layers, h, hd, d)},
        "mlp": {"w_in": (layers, d, f), "w_gate": (layers, d, f), "w_out": (layers, f, d)},
        "norm2": {"scale": (layers, d), "bias": (layers, d)},
    }


def fill(name: str, t: torch.Tensor, cfg: dict) -> bool:
    """The attention output (layers, heads, hd, d): fan-in over heads x hd."""
    if name.endswith("mixer.wo"):
        t.mul_(1.0 / math.sqrt(t.shape[1] * t.shape[2]))
        return True
    return False


def sizes(cfg: dict, program) -> tuple[dict, dict]:
    """(the file's sizes, the program configuration's) to compare."""
    want = {"d_model": cfg["hidden_size"], "num_layers": cfg["num_hidden_layers"],
            "d_ff": cfg["intermediate_size"], "vocab_size": cfg["vocab_size"],
            "num_heads": cfg["num_attention_heads"], "num_kv_heads": cfg["num_key_value_heads"],
            "rope_theta": cfg["rope_theta"], "norm_eps": cfg["layer_norm_eps"],
            "norm": "layernorm", "activation": "swiglu", "qkv_bias": False,
            "tied_embeddings": False, "sliding_window": 0}
    return want, {k: getattr(program, k) for k in want}


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the whole head, halves rotated (x: B, S, H, D)."""
    s, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def block(p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    s = x.shape[1]
    h = models._layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], eps)
    q = _rope(models._einsum("bsd,dhk->bshk", h, p["mixer"]["wq"]), cfg["rope_theta"])
    k = _rope(models._einsum("bsd,dhk->bshk", h, p["mixer"]["wk"]), cfg["rope_theta"])
    v = models._einsum("bsd,dhk->bshk", h, p["mixer"]["wv"])
    group = heads // k.shape[2]
    k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    scores = models._einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(q.shape[-1])
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    att = models._einsum("bhqs,bshk->bqhk", probs, v)
    x = x + models._einsum("bqhk,hkd->bqd", att, p["mixer"]["wo"])
    h = models._layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"], eps)
    gate = models._einsum("bsd,df->bsf", h, p["mlp"]["w_gate"])
    up = models._einsum("bsd,df->bsf", h, p["mlp"]["w_in"])
    return x + models._einsum("bsf,fd->bsd", F.silu(gate) * up, p["mlp"]["w_out"])
