"""Model-facing kernel wrappers: (B, S, heads, D) -> kernel layouts.

On a CUDA tensor each wrapper launches its hand-written kernel or raises;
on a CPU tensor it runs the kernel's plain-torch twin. Nothing else
selects between the two. Under grad, flash attention's kernel runs inside
``FlashAttentionFn`` (its backward recomputes through the twin); the WKV
and scan kernels have no backward yet and raise.
"""

from __future__ import annotations

import torch

from . import flash_attention as fa
from . import mamba_scan as ms
from . import rwkv6 as wkv


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
    if qf.is_cuda and torch.is_grad_enabled() and any(t.requires_grad for t in (qf, kf, vf)):
        out = fa.FlashAttentionFn.apply(qf, kf, vf, group, causal, window, block_k)
    elif qf.is_cuda:
        out = fa.flash_attention_cuda(qf, kf, vf, group=group, causal=causal, window=window)
    else:
        out = fa.flash_attention_plain(
            qf, kf, vf, group=group, causal=causal, window=window, block_k=block_k
        )
    return out.reshape(b, h, s, d).transpose(1, 2)


def rwkv6_chunked(
    r: torch.Tensor,  # (B, T, H, K) float32
    k: torch.Tensor,
    v: torch.Tensor,  # (B, T, H, V)
    logw: torch.Tensor,  # (B, T, H, K)
    u: torch.Tensor,  # (H, K)
    s0: torch.Tensor,  # (B, H, K, V)
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns out (B, T, H, V) in r's dtype and the final state
    (B, H, K, V) in float32. ``chunk`` tiles the plain twin only; the
    kernel picks its own, which changes nothing but rounding."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]

    def flat(x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2).reshape(b * h, t, x.shape[-1])

    uf = u[None].expand(b, h, dk).reshape(b * h, 1, dk)
    args = (flat(r), flat(k), flat(v), flat(logw), uf, s0.reshape(b * h, dk, dv).float())
    if r.is_cuda:
        out, s_final = wkv.rwkv6_cuda(*args)  # tiles time with its own chunk
    else:
        out, s_final = wkv.rwkv6_plain(*args, chunk=chunk)
    return out.reshape(b, h, t, dv).transpose(1, 2), s_final.reshape(b, h, dk, dv)


def mamba_chunk_scan(
    dt: torch.Tensor,  # (B, T, DI) float32
    bmat: torch.Tensor,  # (B, T, N)
    cmat: torch.Tensor,
    a: torch.Tensor,  # (DI, N)
    x: torch.Tensor,  # (B, T, DI)
    h0: torch.Tensor,  # (B, DI, N)
    chunk: int = 64,
    d_block: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns y (B, T, DI) and the final state (B, DI, N), both float32.
    The kernel takes x as it is (float32 or bfloat16, cast on load) and
    steps through time, so ``chunk`` and ``d_block`` only tile the plain
    twin; there ``d_block`` shrinks until it divides DI, as the
    reference's does."""
    if dt.is_cuda:
        return ms.mamba_scan_cuda(dt, bmat, cmat, a, x, h0)
    di = dt.shape[-1]
    d_block = min(d_block, di)
    while di % d_block:
        d_block -= 1
    return ms.mamba_scan_plain(dt, bmat, cmat, a, x.float(), h0, chunk=chunk, d_block=d_block)
