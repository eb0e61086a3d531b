"""RWKV-6 chunked WKV forward for Hopper.

Replaces the reference's Pallas TPU kernel
``src/repro/kernels/rwkv6.py::_wkv_kernel``. Two versions of one function
on the (B·H, T, K) layout, each returning ``(out, s_final)``:

* ``rwkv6_cuda`` launches the hand-written CUDA C++ kernel in
  ``csrc/rwkv6.cu``, built by ``kernels.build`` at first use. It takes
  float32 only, any T, K and V up to 64, and raises on anything else. It
  tiles time with a chunk of its own, so it takes no ``chunk``: the result
  does not depend on the chunk apart from rounding (the log-space pairwise
  decay keeps every exponent <= 0 at any chunk). It counts its launches in
  ``launches``.
* ``rwkv6_plain`` is the plain-torch twin with the Pallas body's
  numerics, chunk by chunk: the in-chunk ``cum`` and ``cum_prev``, the
  pairwise decay ``exp(cum_prev[t] - cum[s])`` for s < t, the ``u`` bonus
  on the diagonal, the cross-chunk term ``r·exp(cum_prev)·S`` and the
  state update, all in float32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .build import KernelBuild
from .build import build as build_kernel

MAX_DIM = 64

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6.cu"

# Kernel launches since the last reset; callers set it to 0 to count a run.
launches = 0


def rwkv6_plain(
    r: torch.Tensor,  # (BH, T, K)
    k: torch.Tensor,  # (BH, T, K)
    v: torch.Tensor,  # (BH, T, V)
    logw: torch.Tensor,  # (BH, T, K), <= 0
    u: torch.Tensor,  # (BH, 1, K)
    s0: torch.Tensor,  # (BH, K, V)
    *,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel. Returns out (BH, T, V) in r's dtype
    and the final state (BH, K, V) in float32."""
    bh, t, dk = r.shape
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk {chunk}")
    uf = u.float()
    s = s0.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    outs = []
    for c0 in range(0, t, chunk):
        rc, kc, vc, lw = (x[:, c0 : c0 + chunk].float() for x in (r, k, v, logw))
        cum = torch.cumsum(lw, dim=1)  # (BH, C, K)
        cum_prev = cum - lw
        diff = cum_prev[:, :, None, :] - cum[:, None, :, :]  # (BH, C, C, K), <= 0 for s < t
        ratio = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        scores = torch.einsum("btk,bsk,btsk->bts", rc, kc, ratio)
        diag = (rc * uf * kc).sum(dim=-1)  # (BH, C) bonus
        out = torch.bmm(scores, vc) + diag[..., None] * vc
        out = out + torch.bmm(rc * torch.exp(cum_prev), s)
        tail = torch.exp(cum[:, -1:] - cum)  # (BH, C, K)
        s = torch.exp(cum[:, -1])[..., None] * s + torch.bmm((kc * tail).transpose(1, 2), vc)
        outs.append(out)
    return torch.cat(outs, dim=1).to(r.dtype), s


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


_build: KernelBuild | None = None


def build() -> KernelBuild:
    """Compile the kernel (once per source and flags) and load it."""
    global _build
    if _build is None:
        kb = build_kernel("rwkv6", SOURCE)
        fn = kb.lib.rwkv6_wkv_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # r k v logw
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u s0 out s_final
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bh t dk dv
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _build = kb
    return _build


def rwkv6_cuda(
    r: torch.Tensor,  # (BH, T, K) float32 on a CUDA device
    k: torch.Tensor,
    v: torch.Tensor,  # (BH, T, V)
    logw: torch.Tensor,
    u: torch.Tensor,  # (BH, 1, K)
    s0: torch.Tensor,  # (BH, K, V)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raise on anything it does not take, and when
    grad mode is on and an input requires grad: the kernel has no backward."""
    global launches
    args = (r, k, v, logw, u, s0)
    if not (r.is_cuda and all(x.device == r.device for x in args)):
        raise ValueError("rwkv6_cuda needs r, k, v, logw, u, s0 on one CUDA device")
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        raise RuntimeError(
            "rwkv6_cuda has no backward yet (ROADMAP queue B: B2's autograd wrapper, with C13); "
            "it would return a tensor without a gradient. Run it under torch.no_grad() or "
            "inference_mode, or train on the CPU")
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError(f"dtypes {[x.dtype for x in args]}: the kernel takes float32 only")
    if r.ndim != 3:
        raise ValueError(f"r {tuple(r.shape)}: need (BH, T, K)")
    bh, t, dk = r.shape
    dv = v.shape[-1]
    shapes = [tuple(x.shape) for x in args]
    if shapes != [(bh, t, dk), (bh, t, dk), (bh, t, dv), (bh, t, dk), (bh, 1, dk), (bh, dk, dv)]:
        raise ValueError(f"shapes {shapes} disagree with r {tuple(r.shape)}")
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM and t >= 1 and bh < 2**31):
        raise ValueError(f"unsupported K={dk} V={dv} T={t} (1 <= K, V <= {MAX_DIM}; T >= 1)")
    r, k, v, logw, u, s0 = (x.contiguous() for x in args)
    out = torch.empty((bh, t, dv), dtype=torch.float32, device=r.device)
    s_final = torch.empty((bh, dk, dv), dtype=torch.float32, device=r.device)
    fn = build().lib.rwkv6_wkv_fwd
    with torch.cuda.device(r.device):
        err = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), out.data_ptr(), s_final.data_ptr(), bh, t, dk, dv,
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return out, s_final
