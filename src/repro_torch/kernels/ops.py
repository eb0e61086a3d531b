"""Model-facing kernel wrappers: (B, S, heads, D) -> kernel layouts.

On the card's path (``on_card``: a CUDA tensor, or any tensor while a
dry-run traces a cell for the card) each wrapper calls its kernel as a
``torch.library`` custom op at the model layout: ``repro_torch::
flash_attention``, ``::rwkv6_chunked`` and ``::mamba_chunk_scan``. On a
CUDA tensor the op launches the hand-written kernel or raises, with no
fallback; on a CPU tensor it runs the plain twin. Each op has

* a fake implementation (``register_fake``), so ``FakeTensorMode``
  traces it as one op that allocates only its outputs, as the kernel does;
* a count for ``torch.utils.flop_counter`` (``register_flop_formula``):
  the operations the bound of its row in ``PERF.md`` §6 counts;
* a DTensor sharding rule (``register_sharding``) at the model layout,
  where batch and heads (channels) are separate dims. The kernels' own
  (B·H, ...) layout merges a dim sharded over ``data`` with one sharded
  over ``model``, which a DTensor cannot express;
* a gradient (``register_autograd``) through a backward op of its own,
  ``::flash_attention_backward`` etc., which recomputes through the
  plain twin and takes its vector-Jacobian product (the reference has
  no backward kernel), with a fake, a count and a sharding of its own.
  This is the only gradient the kernels have: under grad, a CUDA
  tensor's forward launches the kernel once and its backward none.

On a CPU tensor off the card's path the wrappers run the twins directly,
as before the ops existed, and the models' ``cfg.use_pallas`` picks
between a twin and the port of the reference's XLA path.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch
from torch import Tensor
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula

from . import flash_attention as fa
from . import mamba_scan as ms
from . import rwkv6 as wkv

_CARD = threading.local()


@contextlib.contextmanager
def card_path() -> Iterator[None]:
    """Take the card's path on tensors of any device (a dry-run tracing a
    cell for the card on a torch without CUDA, which cannot index fake
    CUDA tensors)."""
    prev = getattr(_CARD, "on", False)
    _CARD.on = True
    try:
        yield
    finally:
        _CARD.on = prev


def on_card(t: Tensor) -> bool:
    """Whether work on ``t`` takes the card's path: the kernels' ops."""
    return t.is_cuda or getattr(_CARD, "on", False)


def _divides(n: int, spec) -> bool:
    """``n`` splits evenly over every mesh dim of ``spec``'s mesh (a
    strategy of a sharding rule may be taken on any of them)."""
    return all(n % size == 0 for size in tuple(spec.mesh.shape))


def _kernel_layout(x: Tensor) -> Tensor:
    """(B, S, N, D) -> (B·N, S, D)."""
    b, s, n, d = x.shape
    return x.transpose(1, 2).reshape(b * n, s, d)


def _model_layout(x: Tensor, b: int) -> Tensor:
    """(B·N, S, D) -> (B, S, N, D), a view."""
    bn, s, d = x.shape
    return x.reshape(b, bn // b, s, d).transpose(1, 2)


R, B0 = Replicate(), Shard(0)

# ---------------------------------------------------------------------------
# B1: flash attention
# ---------------------------------------------------------------------------


@custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int, block_k: int) -> Tensor:
    out = fa.flash_attention_cuda(_kernel_layout(q), _kernel_layout(k), _kernel_layout(v),
                                  group=q.shape[2] // k.shape[2], causal=causal, window=window)
    return _model_layout(out, q.shape[0])


@_flash.register_kernel("cpu")
def _flash_cpu(q, k, v, causal, window, block_k):
    out = fa.flash_attention_plain(_kernel_layout(q), _kernel_layout(k), _kernel_layout(v),
                                   group=q.shape[2] // k.shape[2], causal=causal, window=window,
                                   block_k=block_k)
    return _model_layout(out, q.shape[0])


@_flash.register_fake
def _(q, k, v, causal, window, block_k):
    b, s, h, d = q.shape
    return q.new_empty((b, h, s, d)).transpose(1, 2)


@custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _flash_bwd(grad: Tensor, q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
               block_k: int) -> tuple[Tensor, Tensor, Tensor]:
    grads = fa.plain_grads(_kernel_layout(grad), _kernel_layout(q), _kernel_layout(k),
                           _kernel_layout(v), group=q.shape[2] // k.shape[2], causal=causal,
                           window=window, block_k=block_k)
    return tuple(_model_layout(g, q.shape[0]) for g in grads)


@_flash_bwd.register_fake
def _(grad, q, k, v, causal, window, block_k):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, *opts = inputs
    ctx.save_for_backward(q, k, v)
    ctx.opts = opts


def _flash_grad(ctx, grad):
    dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(grad, *ctx.saved_tensors,
                                                                 *ctx.opts)
    return dq, dk, dv, None, None, None


_flash.register_autograd(_flash_grad, setup_context=_flash_setup)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    """4·B·H·D per visible (query, key) pair (``fa.operations``)."""
    b, s, h, d = q_shape
    return fa.operations(b, h, s, k_shape[1], d, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _flash_bwd_flops(grad_shape, q_shape, k_shape, *args, **kwargs) -> int:
    """The twin's forward over every (query, key) pair, recomputed, and
    its backward, twice that: 12·B·H·D·S_q·S_kv."""
    b, s, h, d = q_shape
    return 3 * fa.operations(b, h, s, k_shape[1], d, causal=False)


def _flash_rules(q, k, n_tensors: int, n_out: int):
    """Replicated, batch-sharded, or head-sharded on q and k/v together.
    Heads only where H and KV both divide every mesh dim: a rank's query
    head h reads its kv head h // group, so sharded q heads must never
    meet replicated (or unevenly split) kv heads."""
    rules = [([R] * n_out, [R] * n_tensors + [None] * 3),
             ([B0] * n_out, [B0] * n_tensors + [None] * 3)]
    if _divides(q.shape[2], q) and _divides(k.shape[2], q):
        rules.append(([Shard(2)] * n_out, [Shard(2)] * n_tensors + [None] * 3))
    return rules


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_sharding(q, k, v, causal, window, block_k):
    return _flash_rules(q, k, 3, 1)


@register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
def _flash_bwd_sharding(grad, q, k, v, causal, window, block_k):
    return _flash_rules(q, k, 4, 3)


def flash_attention(
    q: torch.Tensor,  # (B, S_q, H, D)
    k: torch.Tensor,  # (B, S_kv, KV, D): S_kv != S_q only without causal mask and window
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    block_k: int = 128,  # kv block of the plain twin; the kernel tiles on its own
) -> torch.Tensor:
    if on_card(q):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window, block_k)
    return _flash_cpu(q, k, v, causal, window, block_k)


# ---------------------------------------------------------------------------
# B2: RWKV-6 WKV
# ---------------------------------------------------------------------------


def _wkv_kernel_args(r, k, v, logw, u, s0) -> tuple[Tensor, ...]:
    b, t, h, dk = r.shape
    uf = u[None].expand(b, h, dk).reshape(b * h, 1, dk)
    return (_kernel_layout(r), _kernel_layout(k), _kernel_layout(v), _kernel_layout(logw), uf,
            s0.reshape(b * h, dk, v.shape[-1]).float())


def _wkv_model_out(out: Tensor, s_final: Tensor, r: Tensor) -> tuple[Tensor, Tensor]:
    b, _, h, dk = r.shape
    return _model_layout(out, b), s_final.reshape(b, h, dk, out.shape[-1])


@custom_op("repro_torch::rwkv6_chunked", mutates_args=(), device_types="cuda")
def _wkv(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, s0: Tensor,
         chunk: int) -> tuple[Tensor, Tensor]:
    out, s_final = wkv.rwkv6_cuda(*_wkv_kernel_args(r, k, v, logw, u, s0))  # its own chunk
    return _wkv_model_out(out, s_final, r)


@_wkv.register_kernel("cpu")
def _wkv_cpu(r, k, v, logw, u, s0, chunk):
    out, s_final = wkv.rwkv6_plain(*_wkv_kernel_args(r, k, v, logw, u, s0), chunk=chunk)
    return _wkv_model_out(out, s_final, r)


@_wkv.register_fake
def _(r, k, v, logw, u, s0, chunk):
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    return (r.new_empty((b, h, t, dv)).transpose(1, 2),
            r.new_empty((b, h, dk, dv), dtype=torch.float32))


@custom_op("repro_torch::rwkv6_chunked_backward", mutates_args=())
def _wkv_bwd(grad_out: Tensor, grad_s: Tensor, r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
             u: Tensor, s0: Tensor, chunk: int) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                                         Tensor]:
    _, vjp = torch.func.vjp(lambda *ts: _wkv_cpu(*ts, chunk), r, k, v, logw, u, s0)
    return vjp((grad_out, grad_s))


@_wkv_bwd.register_fake
def _(grad_out, grad_s, r, k, v, logw, u, s0, chunk):
    return tuple(torch.empty_like(t) for t in (r, k, v, logw, u, s0))


def _wkv_setup(ctx, inputs, output):
    *tensors, chunk = inputs
    ctx.save_for_backward(*tensors)
    ctx.chunk = chunk


def _wkv_grad(ctx, grad_out, grad_s):
    grads = torch.ops.repro_torch.rwkv6_chunked_backward(grad_out, grad_s, *ctx.saved_tensors,
                                                         ctx.chunk)
    return (*grads, None)


_wkv.register_autograd(_wkv_grad, setup_context=_wkv_setup)


@register_flop_formula(torch.ops.repro_torch.rwkv6_chunked)
def _wkv_flops(r_shape, k_shape, v_shape, logw_shape, u_shape, s0_shape, chunk, *args,
               **kwargs) -> int:
    """``wkv.operations`` at the op's ``chunk``."""
    b, t, h, dk = r_shape
    return wkv.operations(b * h, t, dk, v_shape[-1], chunk)


@register_flop_formula(torch.ops.repro_torch.rwkv6_chunked_backward)
def _wkv_bwd_flops(go_shape, gs_shape, r_shape, k_shape, v_shape, logw_shape, u_shape, s0_shape,
                   chunk, *args, **kwargs) -> int:
    """The twin recomputed and its backward: 3x the forward's count."""
    b, t, h, dk = r_shape
    return 3 * wkv.operations(b * h, t, dk, v_shape[-1], chunk)


@register_sharding(torch.ops.repro_torch.rwkv6_chunked.default)
def _wkv_sharding(r, k, v, logw, u, s0, chunk):
    S1, S2 = Shard(1), Shard(2)
    rules = [([R, R], [R] * 6 + [None]), ([B0, B0], [B0] * 4 + [R, B0, None])]
    if _divides(r.shape[2], r):
        rules.append(([S2, S1], [S2] * 4 + [B0, S1, None]))
    return rules


@register_sharding(torch.ops.repro_torch.rwkv6_chunked_backward.default)
def _wkv_bwd_sharding(grad_out, grad_s, r, k, v, logw, u, s0, chunk):
    S1, S2 = Shard(1), Shard(2)
    rules = [([R] * 6, [R] * 8 + [None]),
             ([B0] * 4 + [Partial(), B0], [B0] * 6 + [R, B0, None])]
    if _divides(r.shape[2], r):
        rules.append(([S2] * 4 + [B0, S1], [S2, S1] + [S2] * 4 + [B0, S1, None]))
    return rules


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
    (B, H, K, V) in float32. ``chunk`` tiles the plain twin only (on the
    CPU, and in the backward on the card); the kernel picks its own, which
    changes nothing but rounding."""
    if on_card(r):
        return torch.ops.repro_torch.rwkv6_chunked(r, k, v, logw, u, s0, chunk)
    return _wkv_cpu(r, k, v, logw, u, s0, chunk)


# ---------------------------------------------------------------------------
# B3: the Mamba selective scan
# ---------------------------------------------------------------------------


def _d_block(di: int, d_block: int) -> int:
    """The twin's channel tile: shrunk until it divides DI, as the
    reference's is (on a shard, DI is the shard's)."""
    d_block = min(d_block, di)
    while di % d_block:
        d_block -= 1
    return d_block


@custom_op("repro_torch::mamba_chunk_scan", mutates_args=(), device_types="cuda")
def _scan(dt: Tensor, bmat: Tensor, cmat: Tensor, a: Tensor, x: Tensor, h0: Tensor, chunk: int,
          d_block: int) -> tuple[Tensor, Tensor]:
    return ms.mamba_scan_cuda(dt, bmat, cmat, a, x, h0)  # x as it is: float32 or bfloat16


@_scan.register_kernel("cpu")
def _scan_cpu(dt, bmat, cmat, a, x, h0, chunk, d_block):
    return ms.mamba_scan_plain(dt, bmat, cmat, a, x.float(), h0, chunk=chunk,
                               d_block=_d_block(dt.shape[-1], d_block))


@_scan.register_fake
def _(dt, bmat, cmat, a, x, h0, chunk, d_block):
    return dt.new_empty(dt.shape, dtype=torch.float32), h0.new_empty(h0.shape,
                                                                      dtype=torch.float32)


@custom_op("repro_torch::mamba_chunk_scan_backward", mutates_args=())
def _scan_bwd(grad_y: Tensor, grad_h: Tensor, dt: Tensor, bmat: Tensor, cmat: Tensor, a: Tensor,
              x: Tensor, h0: Tensor, chunk: int, d_block: int) -> tuple[Tensor, Tensor, Tensor,
                                                                        Tensor, Tensor, Tensor]:
    # dx comes back in x's dtype through the twin's cast
    _, vjp = torch.func.vjp(lambda *ts: _scan_cpu(*ts, chunk, d_block), dt, bmat, cmat, a, x, h0)
    return vjp((grad_y, grad_h))


@_scan_bwd.register_fake
def _(grad_y, grad_h, dt, bmat, cmat, a, x, h0, chunk, d_block):
    return tuple(torch.empty_like(t) for t in (dt, bmat, cmat, a, x, h0))


def _scan_setup(ctx, inputs, output):
    *tensors, chunk, d_block = inputs
    ctx.save_for_backward(*tensors)
    ctx.tiles = (chunk, d_block)


def _scan_grad(ctx, grad_y, grad_h):
    grads = torch.ops.repro_torch.mamba_chunk_scan_backward(grad_y, grad_h, *ctx.saved_tensors,
                                                            *ctx.tiles)
    return (*grads, None, None)


_scan.register_autograd(_scan_grad, setup_context=_scan_setup)


@register_flop_formula(torch.ops.repro_torch.mamba_chunk_scan)
def _scan_flops(dt_shape, b_shape, *args, **kwargs) -> int:
    """``ms.operations``: about 7 per (b, t, d, n)."""
    b, t, di = dt_shape
    return ms.operations(b, t, di, b_shape[-1])


@register_flop_formula(torch.ops.repro_torch.mamba_chunk_scan_backward)
def _scan_bwd_flops(gy_shape, gh_shape, dt_shape, b_shape, *args, **kwargs) -> int:
    """The twin recomputed and its backward: 3x the forward's count."""
    b, t, di = dt_shape
    return 3 * ms.operations(b, t, di, b_shape[-1])


@register_sharding(torch.ops.repro_torch.mamba_chunk_scan.default)
def _scan_sharding(dt, bmat, cmat, a, x, h0, chunk, d_block):
    S1, S2 = Shard(1), Shard(2)
    rules = [([R, R], [R] * 6 + [None] * 2), ([B0, B0], [B0] * 3 + [R, B0, B0] + [None] * 2)]
    if _divides(dt.shape[2], dt):  # channels: B and C are shared by every channel
        rules.append(([S2, S1], [S2, R, R, B0, S2, S1] + [None] * 2))
    return rules


@register_sharding(torch.ops.repro_torch.mamba_chunk_scan_backward.default)
def _scan_bwd_sharding(grad_y, grad_h, dt, bmat, cmat, a, x, h0, chunk, d_block):
    S1, S2, P = Shard(1), Shard(2), Partial()
    rules = [([R] * 6, [R] * 8 + [None] * 2),
             ([B0, B0, B0, P, B0, B0], [B0] * 5 + [R, B0, B0] + [None] * 2)]
    if _divides(dt.shape[2], dt):
        rules.append(([S2, P, P, B0, S2, S1], [S2, S1, S2, R, R, B0, S2, S1] + [None] * 2))
    return rules


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
    twin (on the CPU, and in the backward on the card); there ``d_block``
    shrinks until it divides DI, as the reference's does."""
    if on_card(dt):
        return torch.ops.repro_torch.mamba_chunk_scan(dt, bmat, cmat, a, x, h0, chunk, d_block)
    return _scan_cpu(dt, bmat, cmat, a, x, h0, chunk, d_block)
