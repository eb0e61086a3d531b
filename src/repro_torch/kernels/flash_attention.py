"""Flash attention forward (GQA + causal + sliding window) for Hopper.

Replaces the reference's Pallas TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel``. Two versions of
one function on the (B·H, S, D) layout, query head ``i`` reading kv head
``i // group``. q has S_q rows and k, v S_kv rows of their own: the
reference's cross-attention (``gqa_scores_softmax_out`` over an image's
patches or an encoder's frames) is the same softmax with S_kv != S_q, which
the Pallas body does not take. The causal mask and the window need S_q ==
S_kv; both versions refuse them otherwise.

* ``flash_attention_cuda`` launches the hand-written CUDA C++ kernel in
  ``csrc/flash_attention.cu``, built by ``kernels.build`` (``nvcc`` for
  ``sm_90a`` into ``build/kernels/`` at first use, loaded with
  ``ctypes``): for bfloat16, both products on the tensor cores
  (``mma.sync``, probabilities rounded to bf16 before p·v, as the
  model-level reference rounds them); for float32, scalar FMAs, since
  TF32 cannot meet the float32 bar. It counts its launches in
  ``launches``.
* ``flash_attention_plain`` is the plain-torch twin with the numerics of
  the Pallas body: an online softmax over kv blocks with a float32
  running max, denominator and accumulator; masked scores set to -1e30
  with p = 0; the final divide clamps the denominator at 1e-30.

* ``plain_grads`` is the backward of every kernel launch: the
  vector-Jacobian product of the plain twin, recomputed (the reference
  has no backward kernel either). ``ops.flash_attention``'s custom op
  takes it as its gradient.

Unlike the Pallas wrapper, neither asserts ``S % block == 0``: both mask
the ragged edge, because on the card the kernel also stands in for the
reference's chunked path, which takes any S.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .build import KernelBuild
from .build import build as build_kernel

NEG_INF = -1e30
MAX_HEAD_DIM = 192  # MLA: qk_nope 128 + qk_rope 64, V padded to it

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset; callers set it to 0 to count a run.
launches = 0


def _check_lengths(s_q: int, s_kv: int, causal: bool, window: int) -> None:
    if s_q != s_kv and (causal or window > 0):
        raise ValueError(f"S_q={s_q} != S_kv={s_kv} takes neither the causal mask nor a window")


def attention_pairs(s_q: int, s_kv: int, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs the mask leaves visible: query i sees
    min(i + 1, window) keys under the causal mask, every key without it."""
    if not causal:
        return s_q * s_kv
    w = min(window, s_q) if window > 0 else s_q
    return w * (w + 1) // 2 + (s_q - w) * w


def operations(b: int, h: int, s_q: int, s_kv: int, d: int, causal: bool = True,
               window: int = 0) -> int:
    """The kernel's floating-point operations: q·k and p·v over the
    visible pairs, 2 each per pair and head-dim element."""
    return 4 * b * h * d * attention_pairs(s_q, s_kv, causal, window)


def flash_attention_plain(
    q: torch.Tensor,  # (BH, S_q, D)
    k: torch.Tensor,  # (BKV, S_kv, D)
    v: torch.Tensor,  # (BKV, S_kv, D)
    *,
    group: int,
    causal: bool = True,
    window: int = 0,
    block_k: int = 128,
) -> torch.Tensor:
    """Plain-torch twin of the kernel: the Pallas body's online softmax,
    one kv block at a time, in float32; output in q's dtype."""
    bh, s, d = q.shape
    s_kv = k.shape[1]
    _check_lengths(s, s_kv, causal, window)
    scale = d**-0.5
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    m = torch.full((bh, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, d), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(s, device=q.device)[:, None]
    block_k = min(block_k, s_kv)
    for k0 in range(0, s_kv, block_k):
        kb, vb = kf[:, k0 : k0 + block_k], vf[:, k0 : k0 + block_k]
        scores = torch.matmul(qf, kb.transpose(1, 2)) * scale  # (BH, S_q, Bk)
        k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        mask = torch.ones((s, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window > 0:
            mask = mask & (k_pos > q_pos - window)
        scores = torch.where(mask, scores, NEG_INF)
        m_cur = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        correction = torch.exp(m - m_cur)
        p = torch.where(mask, torch.exp(scores - m_cur), 0.0)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + torch.matmul(p, vb)
        m = m_cur
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


_build: KernelBuild | None = None


def build() -> KernelBuild:
    """Compile the kernel (once per source and flags) and load it."""
    global _build
    if _build is None:
        kb = build_kernel("flash_attention", SOURCE)
        fn = kb.lib.flash_attention_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bh s_q s_kv d
            ctypes.c_int,  # group
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,  # causal window scale dtype
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _build = kb
    return _build


def flash_attention_cuda(
    q: torch.Tensor,  # (BH, S_q, D) on a CUDA device
    k: torch.Tensor,  # (BKV, S_kv, D)
    v: torch.Tensor,  # (BKV, S_kv, D)
    *,
    group: int,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Launch the CUDA kernel; raise on anything it does not take."""
    global launches
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3:
        raise ValueError(f"shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}: need (BH,S,D)")
    bh, s, d = q.shape
    s_kv = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM or s < 1 or s_kv < 1 or bh > 65535:
        raise ValueError(f"unsupported shape BH={bh} S_q={s} S_kv={s_kv} D={d} (D<=192, BH<=65535)")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need all float32 or all bfloat16")
    if group < 1 or k.shape[0] * group != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and kv {tuple(k.shape)} disagree for group {group}")
    _check_lengths(s, s_kv, causal, window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    fn = build().lib.flash_attention_fwd
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            bh, s, s_kv, d, group, int(causal), int(window), d**-0.5, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    launches += 1
    return o


def plain_grads(grad_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                **opts) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv): the backward of every kernel launch, through the plain
    twin recomputed, by ``torch.func.vjp`` (which also runs inside a custom
    op's implementation, below autograd)."""
    _, vjp = torch.func.vjp(lambda *qkv: flash_attention_plain(*qkv, **opts), q, k, v)
    return vjp(grad_out)
