"""Mamba-1 selective-scan forward for Hopper.

Replaces the reference's Pallas TPU kernel
``src/repro/kernels/mamba_scan.py::_mamba_kernel``. Two versions of one
function, ``h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_t`` and ``y_t = C_t·h_t``
from ``h0``, each returning ``(y, h_final)`` in float32:

* ``mamba_scan_cuda`` launches the hand-written CUDA C++ kernel in
  ``csrc/mamba_scan.cu``, built by ``kernels.build`` at first use. It takes
  x in float32 or bfloat16 (cast on load, as the Pallas body casts it, so
  a bfloat16 x gives the same bits as ``x.float()``) and everything else
  in float32, any T and DI, a state size N of 1 to ``MAX_STATE``, and
  raises on anything else. It runs the recurrence step by step, so it
  takes no ``chunk`` or ``d_block``: the Pallas grid's tiling has no
  counterpart in it. It counts its launches in ``launches``, and
  ``occupancy`` reports its resident blocks per SM.
* ``mamba_scan_plain`` is the plain-torch twin with the Pallas body's
  numerics, chunk by chunk: ``da = exp(dt·a)``, ``dbx = dt·x·B`` as
  (B, C, DI, N), the in-chunk scan, ``h_all = acc_a·h + acc_b``,
  ``y = Σₙ h_all·C`` and the carried state, all in float32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .build import KernelBuild
from .build import build as build_kernel

MAX_STATE = 16
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x's type -> the C interface's x_bf16

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"

# Kernel launches since the last reset; callers set it to 0 to count a run.
launches = 0


def chunk_prefix(da: torch.Tensor, dbx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (da, dbx) under the
    reference's combine ``((a1, b1), (a2, b2)) -> (a1·a2, a2·b1 + b2)``,
    one step at a time (torch has no associative scan)."""
    acc_a, acc_b = [da[:, 0]], [dbx[:, 0]]
    for i in range(1, da.shape[1]):
        acc_a.append(acc_a[-1] * da[:, i])
        acc_b.append(da[:, i] * acc_b[-1] + dbx[:, i])
    return torch.stack(acc_a, dim=1), torch.stack(acc_b, dim=1)


def mamba_scan_plain(
    dt: torch.Tensor,  # (B, T, DI)
    bmat: torch.Tensor,  # (B, T, N)
    cmat: torch.Tensor,  # (B, T, N)
    a: torch.Tensor,  # (DI, N)
    x: torch.Tensor,  # (B, T, DI)
    h0: torch.Tensor,  # (B, DI, N)
    *,
    chunk: int = 64,
    d_block: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel. Returns y (B, T, DI) and the final
    state (B, DI, N), both float32. Channels are independent, so the
    Pallas grid's ``d_block`` tiling is checked but not repeated."""
    t, di = dt.shape[1], dt.shape[2]
    chunk, d_block = min(chunk, t), min(d_block, di)
    if t % chunk or di % d_block:
        raise ValueError(f"T={t} is not a multiple of chunk {chunk}, or DI={di} of "
                         f"d_block {d_block}")
    af = a.float()
    h = h0.float()
    ys = []
    for c0 in range(0, t, chunk):
        dtc, xc, bc, cc = (v[:, c0 : c0 + chunk].float() for v in (dt, x, bmat, cmat))
        da = torch.exp(dtc[..., None] * af)  # (B, C, DI, N)
        dbx = (dtc * xc)[..., None] * bc[:, :, None, :]  # (B, C, DI, N)
        acc_a, acc_b = chunk_prefix(da, dbx)
        h_all = acc_a * h[:, None] + acc_b
        ys.append((h_all * cc[:, :, None, :]).sum(dim=-1))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


_build: KernelBuild | None = None


def build() -> KernelBuild:
    """Compile the kernel (once per source and flags) and load it."""
    global _build
    if _build is None:
        kb = build_kernel("mamba_scan", SOURCE)
        fn = kb.lib.mamba_scan_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dt x b c
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a h0 y h_out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bsz t di n
            ctypes.c_int,  # x_bf16
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        occ = kb.lib.mamba_scan_occupancy
        occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        _build = kb
    return _build


def occupancy(n: int, x_dtype: torch.dtype) -> int:
    """Resident blocks per SM of the kernel launched for state size ``n``
    and x of ``x_dtype`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    on the current device)."""
    blocks = ctypes.c_int(0)
    err = build().lib.mamba_scan_occupancy(n, X_DTYPES[x_dtype], ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"mamba_scan occupancy query failed: CUDA error {err}")
    return blocks.value


def mamba_scan_cuda(
    dt: torch.Tensor,  # (B, T, DI) float32 on a CUDA device
    bmat: torch.Tensor,  # (B, T, N) float32
    cmat: torch.Tensor,  # (B, T, N) float32
    a: torch.Tensor,  # (DI, N) float32
    x: torch.Tensor,  # (B, T, DI) float32 or bfloat16
    h0: torch.Tensor,  # (B, DI, N) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raise on anything it does not take, and when
    grad mode is on and an input requires grad: the kernel has no backward."""
    global launches
    args = (dt, bmat, cmat, a, x, h0)
    if not (dt.is_cuda and all(v.device == dt.device for v in args)):
        raise ValueError("mamba_scan_cuda needs dt, B, C, A, x, h0 on one CUDA device")
    if torch.is_grad_enabled() and any(v.requires_grad for v in args):
        raise RuntimeError(
            "mamba_scan_cuda has no backward yet (ROADMAP queue B: B3's autograd wrapper); it "
            "would return tensors without a gradient. Run it under torch.no_grad() or "
            "inference_mode, or train on the CPU")
    if any(v.dtype != torch.float32 for v in (dt, bmat, cmat, a, h0)) or x.dtype not in X_DTYPES:
        raise TypeError(f"dtypes {[v.dtype for v in args]}: the kernel takes float32, and x "
                        f"in float32 or bfloat16")
    if dt.ndim != 3 or a.ndim != 2:
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(a.shape)}: need (B, T, DI), (DI, N)")
    bsz, t, di = dt.shape
    n = a.shape[1]
    shapes = [tuple(v.shape) for v in args]
    if shapes != [(bsz, t, di), (bsz, t, n), (bsz, t, n), (di, n), (bsz, t, di), (bsz, di, n)]:
        raise ValueError(f"shapes {shapes} disagree with dt {tuple(dt.shape)}, A {tuple(a.shape)}")
    if not (1 <= n <= MAX_STATE and 1 <= bsz <= 65535 and t >= 1 and di >= 1):
        raise ValueError(f"unsupported B={bsz} T={t} DI={di} N={n} "
                         f"(1 <= N <= {MAX_STATE}; B <= 65535)")
    dt, bmat, cmat, a, x, h0 = (v.contiguous() for v in args)
    y = torch.empty((bsz, t, di), dtype=torch.float32, device=dt.device)
    h_out = torch.empty((bsz, di, n), dtype=torch.float32, device=dt.device)
    fn = build().lib.mamba_scan_fwd
    with torch.cuda.device(dt.device):
        err = fn(
            dt.data_ptr(), x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), bsz, t, di, n, X_DTYPES[x.dtype],
            torch.cuda.current_stream(dt.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, h_out
