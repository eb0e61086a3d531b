"""Operations and bytes behind the benchmark's rooflines and model-FLOP
shares, from shapes alone.

The kernel counts are copied from the port's own formulas (the flash
kernel's and the WKV kernel's ``operations``, ``chip_smoke.py``'s bounds)
and checked against them by hand-worked shapes in the tests. Each input
byte is read once and each output byte written once.

The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet): 989e12 dense
operations a second, the tensor cores' bf16 rate, taken as the compute
ceiling for every dtype so that no float32 implementation can read over
100%, and 3.35e12 bytes a second of HBM3.
"""

from __future__ import annotations

import math

from . import models

PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def attention_pairs(s_q: int, s_kv: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs a mask leaves visible."""
    if not causal:
        return s_q * s_kv
    w = min(window, s_q) if window > 0 else s_q
    return w * (w + 1) // 2 + (s_q - w) * w


def flash_attention(b: int, s_q: int, h: int, d: int, s_kv: int, kv: int, itemsize: int,
                    causal: bool = True, window: int = 0) -> tuple[int, int]:
    """(operations, bytes) of one flash-attention call on q (B, S_q, H, D),
    k and v (B, S_kv, KV, D): q·k and p·v over the visible pairs, 2 each a
    pair and head-dim element; q, k, v read and the output written once."""
    ops = 4 * b * h * d * attention_pairs(s_q, s_kv, causal, window)
    nbytes = itemsize * (2 * b * s_q * h * d + 2 * b * s_kv * kv * d)
    return ops, nbytes


def wkv(bh: int, t: int, dk: int, dv: int, chunk: int) -> tuple[int, int]:
    """(operations, bytes) of one chunked WKV-6 call over ``bh`` heads of
    T steps, float32: the in-chunk decays, the pairwise scores and the
    bonus, the scores times v, the cross-chunk term and the state update;
    r, k, logw, v, u and the initial state read, the output and the final
    state written."""
    c, n = chunk, t // chunk
    per_chunk = (
        2 * c * dk
        + c * (c - 1) // 2 * dk * 5
        + 3 * c * dk
        + c * (c + 1) // 2 * dv * 2
        + 2 * c * dk + 2 * c * dk * dv
        + 3 * c * dk + dk
        + dk * dv * (1 + 2 * c)
    )
    nbytes = 4 * (bh * t * (3 * dk + dv) + bh * dk + bh * dk * dv + bh * t * dv + bh * dk * dv)
    return bh * n * per_chunk, nbytes


def least_seconds(ops: int, nbytes: int) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def flash_attention_least(shapes: list, itemsize: int) -> float:
    """One call's least seconds from its q and k shapes (B, S, H, D), causal."""
    (b, s_q, h, d), (_, s_kv, kv, _) = shapes[0], shapes[1]
    return least_seconds(*flash_attention(b, s_q, h, d, s_kv, kv, itemsize))


def wkv_chunk(t: int, chunk: int = 32) -> int:
    """The chunk the model passes for T steps: ``min(chunk, T)``, shrunk
    until it divides T."""
    c = min(chunk, t)
    while t % c:
        c -= 1
    return c


def wkv_least(shapes: list, itemsize: int) -> float:
    """One WKV call's least seconds from r (B, T, H, K) and v (B, T, H, V)."""
    (b, t, h, dk), v = shapes[0], shapes[2]
    return least_seconds(*wkv(b * h, t, dk, v[-1], wkv_chunk(t)))


def param_count(cfg: dict) -> int:
    """Parameters of a configuration file's model (embedding and head
    included), every expert among them: what sizes its memory."""
    from .. import weights

    return sum(math.prod(shape) for _, shape in weights.leaves(weights.layout(cfg)))


def active_params(cfg: dict) -> int:
    """N of the model FLOPs: the parameters a token passes through, the
    family's ``active_params(cfg)`` where it has experts (a token passes
    through its own), by default all of them."""
    fam = models.family(cfg)
    return fam.active_params(cfg) if hasattr(fam, "active_params") else param_count(cfg)


def attention_layers(cfg: dict) -> int:
    """The layers whose q·k and p·v count: the family's
    ``attention_layers(cfg)`` where only some layers attend, by default
    every layer of a family with ``ATTENTION`` and none of one without."""
    fam = models.family(cfg)
    if hasattr(fam, "attention_layers"):
        return fam.attention_layers(cfg)
    return cfg["num_hidden_layers"] if fam.ATTENTION else 0


def request_flops(cfg: dict, prompt: int, output: int) -> int:
    """Model FLOPs of serving one request: 2·N a token for its prompt and
    its asked output tokens (N the active parameters), plus q·k and p·v
    (4·d an attention layer) for every position each token sees, itself
    included."""
    per_pos = 4 * attention_layers(cfg) * cfg["hidden_size"]
    seen = sum(range(1, prompt + 1)) + sum(range(prompt + 1, prompt + output + 1))
    return 2 * active_params(cfg) * (prompt + output) + per_pos * seen


def train_step_flops(cfg: dict, batch: int, seq_len: int) -> int:
    """Model FLOPs of one train step: 6·N a token (N the active
    parameters), plus the forward's q·k and p·v over the causal pairs (4·d
    a pair and attention layer) three times (forward and backward)."""
    attention = 3 * 4 * attention_layers(cfg) * cfg["hidden_size"] * attention_pairs(
        seq_len, seq_len) * batch
    return 6 * active_params(cfg) * batch * seq_len + attention
