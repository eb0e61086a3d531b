"""Single-token attention against the KV cache (decode), the cache read in
place: B4.

Replaces no TPU kernel: the reference decodes with plain softmax attention
(``src/repro/models/attention.py::attn_decode``), which XLA fuses on the
TPU. On the card its two einsums batch over (b, kv), which the cache's
(B, T, KV, D) layout cannot merge, so torch copied each layer's whole K
and V into a permuted layout on every decode step, then read the copies
in two batched GEMVs, over every row of the cache. The kernel reads the
live rows ``n = min(pos + 1, T)`` where they lie, once each: its bound is
the bytes of those rows plus q and out (``bytes_moved``), and it streams
them once. Two versions of one function on the model's layout, q
(B, 1, H, D) and the cache's k, v (B, T, KV, D), H = KV·G:

* ``decode_attention_cuda`` launches the hand-written CUDA C++ kernel in
  ``csrc/decode_attention.cu`` (its design there), built by
  ``kernels.build`` at first use: float32 or bfloat16, every product a
  float32 FMA. It reads ``pos`` from device memory, so a captured graph
  attends over the rows of the step it replays. It counts one launch a
  call in ``launches``, whatever its passes (one, or two when the rows
  are split).
* ``decode_attention_plain`` is the plain twin: ``attn_decode``'s masked
  ``gqa_scores_softmax_out`` (below), the arithmetic the CPU path runs.

A cache whose rows are sharded over cards (a dry-run's mesh, where the kv
heads do not divide the model axis) is read in place too: on each shard
``decode_partial_cuda`` (twin ``decode_partial_plain``) writes the float32
partial (acc, m, l) of every split of its live rows, and
``combine_partials`` joins the partials of all shards, the kernel's own
combine in torch ops.
"""

from __future__ import annotations

import ctypes
import math
import re
from pathlib import Path

import torch

from .build import KernelBuild
from .build import build as build_kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
# (head dim, query heads a kv head): the kernel's instances, as its source's
# by_shape lists them (every pair of the port's configurations, smoke and full)
SHAPES = frozenset((int(d), int(g)) for d, g in
                   re.findall(r"DECODE_SHAPE\((\d+), (\d+)\)", SOURCE.read_text()))
SMS = 132  # an H100 SXM's streaming multiprocessors
WAVE_BLOCKS = 2 * SMS  # blocks, at least, that the rows are split into: two for each SM
MIN_SPLIT_ROWS = 32  # rows a split reads, at least

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Calls since the last reset (one a call, whatever its passes); callers set it to 0 to count a run.
launches = 0


def gqa_scores_softmax_out(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KV, D)
    v: torch.Tensor,  # (B, Skv, KV, D)
    mask: torch.Tensor | None,  # broadcastable to (B, KV, G, Sq, Skv) or (Sq, Skv)
) -> torch.Tensor:
    """The reference's ``gqa_scores_softmax_out`` on plain tensors: scores
    in float32, masked to float32's lowest, softmax, probabilities in v's
    dtype (``models.attention`` wraps it for DTensors)."""
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


def live_mask(pos: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,): the rows a decode at ``pos`` (a (1,) tensor) attends to,
    ``t < min(pos + 1, rows)``: a contiguous cache's rows <= pos, a ring
    buffer's slots written so far."""
    return torch.arange(rows, device=pos.device) < (pos + 1).clamp(max=rows)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Plain twin: q (B, 1, H, D) against the cache's k, v (B, T, KV, D)
    over the live rows; out (B, 1, H, D) in v's dtype."""
    valid = live_mask(pos.reshape(1), k.shape[1])
    return gqa_scores_softmax_out(q, k, v, valid[None, None, None, None, :])


NEG_INF = -1e30  # an empty split's running max, as the kernel writes it


def decode_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         live: torch.Tensor) -> torch.Tensor:
    """Plain twin of the partials: q (B, 1, H, D) against the cache's rows
    t < ``live`` (a (1,) tensor, 0 to T), in the kernel's splits of the rows
    (``splits_for``); (B, H, splits, D + 2) in float32: each split's
    sum of p·v, its max score m (``NEG_INF`` when it has no live rows) and
    its sum l of p = exp(score - m)."""
    b, _, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    splits = splits_for(b * kv, t)
    per = -(-t // splits)
    pad = splits * per - t
    valid = torch.arange(t, device=k.device) < live.reshape(1).clamp(0, t)
    qg = q.reshape(b, kv, h // kv, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * d**-0.5
    scores = torch.where(valid, scores, -math.inf)
    scores = torch.nn.functional.pad(scores, (0, pad), value=-math.inf)
    scores = scores.reshape(b, kv, h // kv, splits, per)
    m = scores.amax(-1).clamp(min=NEG_INF)
    probs = torch.exp(scores - m[..., None])
    vs = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).reshape(b, splits, per, kv, d)
    acc = torch.einsum("bkgsr,bsrkd->bkgsd", probs, vs)
    return torch.cat([acc, m[..., None], probs.sum(-1)[..., None]], -1).reshape(
        b, h, splits, d + 2)


def combine_partials(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Out (B, 1, H, D) in ``dtype`` from the partials (B, H, S, D + 2) of
    every split of every shard: sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M),
    M the largest m_s."""
    d = part.shape[-1] - 2
    acc, m, l = part[..., :d], part[..., d], part[..., d + 1]
    w = torch.exp(m - m.amax(2, keepdim=True))
    return ((acc * w[..., None]).sum(2) / (l * w).sum(2)[..., None])[:, None].to(dtype)


def operations(b: int, h: int, n: int, d: int) -> int:
    """The kernel's floating-point operations over ``n`` live rows: q·k and
    p·v, 2 each per row, head and head-dim element."""
    return 4 * b * h * n * d


def bytes_moved(b: int, h: int, kv: int, n: int, d: int, itemsize: int) -> int:
    """The least bytes: each live K and V row read once, q read and out
    written once."""
    return (2 * b * n * kv * d + 2 * b * h * d) * itemsize


def splits_for(bkv: int, rows: int) -> int:
    """Splits of the cache's rows: enough blocks (``bkv`` a split) for
    ``WAVE_BLOCKS``, each split ``MIN_SPLIT_ROWS`` rows or more. From the
    shapes alone, so a captured graph's launch never changes. Measured as
    graph replays on an H100: 32 x 32 (b, kv) heads over 768 rows run
    fastest unsplit; 4 x 8 heads over 2,064 rows at 8-12 splits, one
    sequence's 8 over a 4,096-slot ring at 24-32, each 2-5x faster than
    unsplit."""
    return max(1, min(math.ceil(WAVE_BLOCKS / bkv), rows // MIN_SPLIT_ROWS))


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


_build: KernelBuild | None = None


def build() -> KernelBuild:
    """Compile the kernel (once per source and flags) and load it."""
    global _build
    if _build is None:
        kb = build_kernel("decode_attention", SOURCE)
        fn = kb.lib.decode_attention_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v pos
            ctypes.c_void_p, ctypes.c_void_p,  # out part
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b t kv d g
            ctypes.c_longlong, ctypes.c_longlong,  # stride_b stride_t
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,  # splits scale dtype partial
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _build = kb
    return _build


def decode_attention_cuda(
    q: torch.Tensor,  # (B, 1, H, D) on a CUDA device
    k: torch.Tensor,  # (B, T, KV, D), read in place
    v: torch.Tensor,  # (B, T, KV, D), k's strides
    pos: torch.Tensor,  # (1,) int64 on the same device
) -> torch.Tensor:
    """Launch the CUDA kernel; raise on anything it does not take."""
    return _launch(q, k, v, pos, partial=False)


def decode_partial_cuda(
    q: torch.Tensor,  # (B, 1, H, D) on a CUDA device
    k: torch.Tensor,  # (B, T, KV, D): a shard of the cache's rows, read in place
    v: torch.Tensor,
    live: torch.Tensor,  # (1,) int64: the shard's live rows, 0 to T
) -> torch.Tensor:
    """The kernel in partial mode: ``decode_partial_plain``'s (B, H, splits,
    D + 2) float32 partials; raise on anything it does not take."""
    return _launch(q, k, v, live, partial=True)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
            partial: bool) -> torch.Tensor:
    global launches
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}: "
                         f"need (B, 1, H, D) and (B, T, KV, D)")
    b, _, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    group = h // kv
    if k.shape[0] != b or k.shape[3] != d or group * kv != h:
        raise ValueError(f"q {tuple(q.shape)} and the cache {tuple(k.shape)} disagree")
    if (d, group) not in SHAPES or b * kv > 65535:
        raise ValueError(f"unsupported D={d} G={group} B*KV={b * kv} "
                         f"((D, G) in {sorted(SHAPES)}, B*KV <= 65535)")
    if not (q.is_cuda and all(x.device == q.device for x in (k, v, pos))):
        raise ValueError("decode_attention_cuda needs q, k, v and pos on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need all float32 or all bfloat16")
    if pos.dtype != torch.int64 or pos.numel() != 1:
        raise TypeError(f"pos {pos.dtype} {tuple(pos.shape)}: need one int64")
    vec = 16 // k.element_size()
    if (k.stride() != v.stride() or k.stride()[2:] != (d, 1)
            or k.stride(0) % vec or k.stride(1) % vec
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(f"cache strides {k.stride()} / {v.stride()}: need (*, *, D, 1), the "
                         f"same for k and v, in whole 16-byte rows from 16-byte aligned bases")
    splits = splits_for(b * kv, t)
    q = q.contiguous()
    out = None if partial else torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    part = (torch.empty((b, h, splits, d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 or partial else None)
    fn = build().lib.decode_attention_fwd
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            None if out is None else out.data_ptr(), None if part is None else part.data_ptr(),
            b, t, kv, d, group, k.stride(0), k.stride(1), splits, d**-0.5,
            _DTYPE_CODES[q.dtype], int(partial), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA error {err}")
    launches += 1
    return part if partial else out
