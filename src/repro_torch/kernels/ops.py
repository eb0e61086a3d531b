"""Model-facing kernel wrappers: (B, S, heads, D) -> kernel layouts.

On a CUDA tensor each wrapper launches its hand-written kernel or raises;
on a CPU tensor it runs the kernel's plain-torch twin. Nothing else
selects between the two.
"""

from __future__ import annotations

import torch

from . import flash_attention as fa


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    block_k: int = 128,  # kv block of the plain twin; the kernel tiles on its own
) -> torch.Tensor:
    b, s, h, d = q.shape
    kv = k.shape[2]
    group = h // kv
    qf = q.transpose(1, 2).reshape(b * h, s, d)
    kf = k.transpose(1, 2).reshape(b * kv, s, d)
    vf = v.transpose(1, 2).reshape(b * kv, s, d)
    if qf.is_cuda:
        out = fa.flash_attention_cuda(qf, kf, vf, group=group, causal=causal, window=window)
    else:
        out = fa.flash_attention_plain(
            qf, kf, vf, group=group, causal=causal, window=window, block_k=block_k
        )
    return out.reshape(b, h, s, d).transpose(1, 2)
