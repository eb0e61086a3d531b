#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. the card: name and power limit;
  2. the build: ``nvcc`` compiles the three kernels (flash attention,
     RWKV-6 WKV, Mamba selective scan) for sm_90a from the checkout's
     sources, in parallel, and prints their registers, shared memory and
     spills, and the Mamba scan's resident blocks per SM;
  3. each kernel against its plain-torch twin on the card, case by case
     (the Mamba scan also at both ends of jamba's decay range and with x
     in bfloat16);
  4. the slices: stablelm-3b and rwkv6-7b at full width and depth, and
     jamba-1.5-large without experts at full width and 16 layers, each in
     bf16 with seeded random weights, answer 8 requests in batches of 4
     through the batch handler; with every launch count set to 0 just
     before, each kernel must launch exactly as often per prefill as the
     slice's layout says (and a kernel it does not name, never), and
     greedy output must repeat exactly;
  5. granite, rwkv6 and jamba (smoke, f32) on the card (kernels) against
     the CPU (plain twins) on the same weights: logits and greedy tokens;
  6. ``[grad]``: flash attention under grad (``FlashAttentionFn``): one
     kernel launch per forward, the kernel's own output, and dq/dk/dv
     against autograd through the plain twin on the card; the WKV and scan
     kernels refuse to run under grad; the backward's recomputation timed
     at stablelm's training shape;
  7. ``[train-full]``: stablelm-3b at full width and depth (bf16, remat
     "full", AdamW, B=4, S=1024, 2 microbatches) takes 3 steps of
     ``make_train_step``: finite losses and grad norms, a first CE near
     ln V, every parameter leaf changed, and exactly 128 flash attention
     launches a step (32 layers, forward and recomputation, per
     microbatch); step time, tokens/s, peak memory, a profiled step's
     device busy time and idle share, and a breakdown (forward, backward,
     the recomputation through the twin, the optimizer update);
  8. ``[continuum]``: the reference's main path on the card at smoke size
     in float32 through ``runtime.train_loop``: ``prepare_data``, ``train``
     crashing at step 3 and resuming from ``latest.json``, ``evaluate``, and
     a ``ServeEngine`` on the restored parameters behind the batch handler;
     straight and resumed runs agree at atol 1e-6 (deterministic
     algorithms, in a process of its own with a fixed cuBLAS workspace),
     and greedy tokens equal those of the in-memory params;
  9. ``[train-cross]``: three smoke f32 steps on the card against the CPU on
     the same parameters and batches, AdamW and Adafactor, 1 and 2
     microbatches: loss, grad norm and parameters at ``TRAIN_CROSS_*``;
 10. ``[broker]``: the port's copy of the broker (``repro_torch.broker``)
     in a process of its own (``BROKER_SOURCE``: signatures verified, no
     torch, no jax, no module of ``repro``), reached
     only over HTTP through the port's signed client; the colony, and the
     mean round trip of 20 signed ``colonystats``;
 11. ``[executors-continuum]``: both DAGs of the reference's continuum test
     on the port's executors on the card (smoke, f32): train, restore from
     CFS and serve through a generator; then prepare_data -> train (two
     trainers crash at step 3, the failsafe re-queues at a lease of 3x the
     measured attempt, the resume) -> evaluate, with flash attention's
     launches counted for the steps and batches that ran;
 12. ``[executors-serve-full]``: a ServeExecutor of full-width stablelm-3b
     (float32) behind a generator of queuesize 4: 8 signed requests over
     HTTP in 2 batches, 32 flash attention launches a prefill, tokens equal
     to the engine's own generate; wall time, requests/s, tokens/s, the
     engine's seconds per batch and the share outside it (requests 5-8
     wait until batch 1 is on the engine; that wait is reported); this process
     then holds no module of ``repro`` or JAX;
 13. each kernel, its plain twin and, where there is one, a PyTorch call
     computing the same function, timed at a prefill shape and at the
     serving shapes beside the card's bound (the Mamba scan also beside
     the least time of its exponentials on the special-function unit).
The last line is the JSON result; the line before it lists the kernels,
and the one before that names the card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3

# (B, S, H, KV, D, window, plain-twin kv block, dtype, atol, rtol, label)
FLASH_CASES = [
    (1, 128, 4, 4, 32, 0, 64, torch.float32, 2e-5, 1e-4, "MHA"),
    (2, 128, 4, 2, 32, 0, 64, torch.float32, 2e-5, 1e-4, "GQA group 2"),
    (1, 256, 8, 2, 64, 0, 128, torch.float32, 2e-5, 1e-4, "GQA group 4, D=64"),
    (2, 128, 4, 2, 32, 48, 32, torch.float32, 2e-5, 1e-4, "sliding window 48"),
    (1, 64, 2, 1, 16, 0, 16, torch.float32, 2e-5, 1e-4, "tiny blocks"),
    (1, 300, 4, 2, 64, 0, 128, torch.float32, 2e-5, 1e-4, "ragged S=300 f32"),
    (2, 128, 4, 2, 32, 0, 64, torch.bfloat16, 3e-2, 3e-2, "bf16"),
    (2, 1024, 32, 32, 80, 0, 128, torch.bfloat16, 3e-2, 3e-2, "stablelm B=2 S=1024"),
    (2, 512, 32, 8, 128, 0, 128, torch.bfloat16, 3e-2, 3e-2, "granite GQA group 4, D=128"),
    (4, 300, 32, 32, 80, 0, 128, torch.bfloat16, 3e-2, 3e-2, "stablelm serving S=300 (ragged)"),
    (4, 200, 32, 32, 80, 0, 128, torch.bfloat16, 3e-2, 3e-2, "stablelm serving S=200 (ragged)"),
    (4, 300, 64, 8, 128, 0, 128, torch.bfloat16, 3e-2, 3e-2, "jamba GQA group 8, D=128"),
    (2, 128, 4, 2, 16, 0, 64, torch.bfloat16, 3e-2, 3e-2, "bf16 D=16"),
    (2, 256, 8, 2, 64, 0, 128, torch.bfloat16, 3e-2, 3e-2, "bf16 D=64"),
    (1, 200, 8, 4, 72, 0, 128, torch.bfloat16, 3e-2, 3e-2, "bf16 D=72 (padded to 80), ragged"),
    (2, 128, 4, 2, 32, 48, 32, torch.bfloat16, 3e-2, 3e-2, "bf16 sliding window 48"),
    (1, 300, 16, 2, 128, 100, 128, torch.bfloat16, 3e-2, 3e-2, "bf16 window 100, GQA group 8"),
    (1, 77, 4, 1, 20, 0, 128, torch.bfloat16, 3e-2, 3e-2, "bf16 D=20 (plain loads), ragged"),
    # float32 at the shapes the executors' handlers give the kernel
    (2, 16, 4, 4, 16, 0, 16, torch.float32, 2e-5, 1e-4, "executors smoke train/eval f32"),
    (4, 16, 4, 4, 16, 0, 16, torch.float32, 2e-5, 1e-4, "executors smoke serve f32"),
    (4, 300, 32, 32, 80, 0, 128, torch.float32, 2e-5, 1e-4, "executors stablelm serving S=300 f32"),
    (4, 200, 32, 32, 80, 0, 128, torch.float32, 2e-5, 1e-4, "executors stablelm serving S=200 f32"),
]
# (S, D, dtype, atol, rtol): bidirectional, ragged S, GQA group 2
BIDIR_CASES = [
    (200, 32, torch.float32, 2e-5, 1e-4),
    (300, 80, torch.bfloat16, 3e-2, 3e-2),
    (200, 128, torch.bfloat16, 3e-2, 3e-2),
]
PROMPT_LENS = [8, 300, 37, 129, 64, 200, 17, 150]  # batches of 4: S = 300, then 200
NEW_TOKENS = 16
TIMING_SHAPE = (4, 2048, 32, 32, 80)  # B, S, H, KV, D: stablelm prefill
FLASH_SERVING_SHAPES = {"stablelm S=300": (4, 300, 32, 32, 80), "jamba S=300": (4, 300, 64, 8, 128)}

# (B, T, H, K = V, chunk, nonzero s0, constant logw or None, label); f32,
# atol 1e-4 / rtol 1e-3 as in tests/test_kernels.py. The chunk tiles the
# plain twin; the kernel tiles time with its own.
WKV_CASES = [
    (1, 32, 2, 8, 16, False, None, "reference case 1"),
    (2, 64, 3, 16, 16, False, None, "reference case 2"),
    (2, 96, 2, 16, 32, False, None, "reference case 3"),
    (1, 32, 2, 8, 8, True, None, "nonzero s0"),
    (1, 64, 1, 8, 32, False, -30.0, "logw = -30"),
    (2, 300, 4, 64, 30, True, None, "chunk 30"),
    (2, 200, 4, 64, 25, True, None, "chunk 25"),
    (2, 293, 4, 64, 1, True, None, "chunk 1, T=293"),
    (4, 300, 64, 64, 30, True, None, "rwkv6-7b width, B=4 T=300"),
    (2, 293, 4, 64, 1, False, -30.0, "logw = -30, chunk 1, T=293"),
    (2, 45, 2, 6, 5, True, None, "K=V=6 (4-byte copies)"),
]
WKV_ATOL, WKV_RTOL = 1e-4, 1e-3
# rwkv6 and jamba: batches of 4 pad to T = 300 (WKV chunk 30, scan chunk
# 60), then T = 293 (prime: chunk 1 in both)
PRIME_PROMPT_LENS = [8, 300, 37, 129, 64, 293, 17, 150]
WKV_TIMING_SHAPE = (4, 2048, 64, 64, 32)  # B, T, H, K = V, chunk: rwkv6-7b prefill
WKV_SERVING_SHAPE = (4, 293, 64, 64, 1)  # a prime-length prompt: chunk 1

# (B, T, DI, N, chunk, nonzero h0, draw, x dtype, label); atol 1e-4 / rtol
# 1e-3 as in tests/test_kernels.py. The first three are that file's
# MAMBA_CASES. The chunk tiles the plain twin; the kernel steps through time
# and takes none. The draws are those of mamba_inputs.
MAMBA_CASES = [
    (1, 64, 32, 4, 32, False, "reference", torch.float32, "reference case 1"),
    (2, 128, 64, 8, 32, False, "reference", torch.float32, "reference case 2"),
    (2, 64, 96, 16, 16, False, "reference", torch.float32, "reference case 3"),
    (1, 32, 16, 4, 16, True, "reference", torch.float32, "nonzero h0"),
    (2, 64, 100, 16, 16, True, "reference", torch.float32, "ragged DI=100"),
    (2, 300, 512, 16, 60, True, "reference", torch.float32, "chunk 60, T=300"),
    (2, 293, 512, 16, 1, True, "reference", torch.float32, "chunk 1, T=293"),
    (4, 300, 16384, 16, 60, True, "reference", torch.float32, "jamba width, B=4 T=300"),
    (1, 2048, 512, 16, 64, True, "slow decay", torch.float32, "slow decay, T=2048"),
    (2, 300, 512, 16, 60, True, "deep underflow", torch.float32, "deep underflow"),
    (4, 300, 16384, 16, 60, True, "reference", torch.bfloat16, "bf16 x, jamba width, B=4 T=300"),
    (2, 64, 100, 16, 16, True, "reference", torch.bfloat16, "bf16 x, ragged DI=100"),
]
MAMBA_ATOL, MAMBA_RTOL = 1e-4, 1e-3
# jamba no-moe: 14 Mamba and 2 attention layers; batches of 4 pad to
# T = 300 (scan chunk 60), then T = 293 (prime: chunk 1)
JAMBA_PER_PREFILL = {"mamba_scan": 14, "flash_attention": 2}
MAMBA_TIMING_SHAPE = (4, 2048, 16384, 16, 64)  # B, T, DI, N, chunk: jamba prefill
MAMBA_SERVING_SHAPES = {"T=300": (4, 300, 16384, 16, 60), "T=293": (4, 293, 16384, 16, 1)}
MUFU_PER_CLOCK = 16  # exponentials per clock on each SM (ex2 on the special-function unit)

# [grad]: FLASH_CASES labels whose gradients are checked on the card
GRAD_CASES = ["MHA", "GQA group 4, D=64", "sliding window 48", "ragged S=300 f32", "bf16",
              "stablelm B=2 S=1024"]
# [train-full]: stablelm-3b, B=4, S=1024, 2 microbatches, 3 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 1024, 2, 3
# [continuum]: the reference handlers' smoke run, cut to 6 steps of 4 x 64.
# It turns deterministic algorithms on, and cuBLAS is deterministic only
# with a fixed workspace, set before CUDA starts: so it runs in a process
# of its own with this environment, and every other phase runs with the
# default workspace.
CONTINUUM_KW = dict(arch="stablelm-3b", steps=6, batch=4, seq_len=64, checkpoint_every=2)
CONTINUUM_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# [train-cross]: cuda against cpu after 3 smoke f32 steps; the largest
# differences measured on an H100 were 1.9e-6 (grad norm) and 3.2e-7 (params)
TRAIN_CROSS_ATOL, TRAIN_CROSS_RTOL = 1e-5, 1e-5


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def plain_bshd(q, k, v, causal, window, block_k):
    """The plain twin on the model-facing layout, as ops.flash_attention
    reshapes for the kernel."""
    from repro_torch.kernels import flash_attention as fa

    b, s, h, d = q.shape
    kv = k.shape[2]
    out = fa.flash_attention_plain(
        q.transpose(1, 2).reshape(b * h, s, d), k.transpose(1, 2).reshape(b * kv, s, d),
        v.transpose(1, 2).reshape(b * kv, s, d), group=h // kv, causal=causal,
        window=window, block_k=block_k,
    )
    return out.reshape(b, h, s, d).transpose(1, 2)


def cuda_ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time per call: for each kernel ``fn`` launches, its
    device time under the profiler over the launches the profiler recorded
    of it (at most ``iters``), summed over the kernels. Unlike ``cuda_ms``
    it leaves out any gap between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records nothing: ask again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = max((e.count for e in events), default=0)
        if calls:
            break
    check(0 < calls <= iters, f"the profiler recorded {calls} launches of {iters} calls")
    if calls < iters:
        print(f"[time] the profiler recorded {calls} of {iters} calls")
    return sum(e.self_device_time_total / e.count for e in events if e.count) / 1e3


def timed(fn, warmup: int, iters: int, dev_iters: int, bound_ms: float,
          what: str) -> tuple[float, float]:
    """(``cuda_ms``, ``device_ms``) of ``fn``. The device time is the mean
    of two profiles, and all is measured again (at most five times) until
    the two agree within 5% and both lie between the bound and the events
    time (with 5% for noise): a profile that kept a launch's count but lost
    part of its time reads below what the card did, and one that kept stray
    time reads above the events' wall time."""
    for _ in range(5):
        events_ms = cuda_ms(fn, warmup, iters)
        devs = [device_ms(fn, dev_iters) for _ in range(2)]
        if bound_ms <= min(devs) and max(devs) <= min(events_ms * 1.05, min(devs) * 1.05):
            return events_ms, sum(devs) / 2
        print(f"[time] {what}: device {devs[0]:.4f} and {devs[1]:.4f} ms disagree, or lie "
              f"outside [bound {bound_ms:.4f} ms, 1.05 x events {events_ms:.4f} ms]; measuring "
              f"again")
    check(False, f"{what}: no two device times that agree between the bound and the events time")


def smi(query: str, units: bool = False) -> str:
    """``nvidia-smi --query-gpu=<query>`` for the first card, as CSV without
    a header (and without units unless asked)."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def phase_card() -> str:
    card = smi("name,power.limit", units=True)
    print(f"[card] nvidia-smi: {card}")
    print(f"[card] torch: {torch.cuda.get_device_name(0)}, devices: {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


def kernel_modules() -> dict:
    """Each kernel's module, by the name the kernels line gives it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rwkv6 as wkv

    return {"flash_attention": fa, "rwkv6_wkv": wkv, "mamba_scan": ms}


def phase_build() -> None:
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    mods = kernel_modules()
    with ThreadPoolExecutor(len(mods)) as pool:
        futures = {name: pool.submit(mod.build) for name, mod in mods.items()}
        builds = {name: f.result() for name, f in futures.items()}
    for name, kb in builds.items():
        print(f"[build] {name}: {' '.join(kb.command) if kb.command else 'reused ' + str(kb.path)}")
        for line in kb.log.splitlines():
            if line.strip():
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    ms = mods["mamba_scan"]
    for dtype in (torch.float32, torch.bfloat16):
        print(f"[build] mamba_scan N=16, x {str(dtype).split('.')[-1]}: "
              f"{ms.occupancy(16, dtype)} resident blocks of 128 threads per SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")


def phase_kernel_cases() -> float:
    """Kernel against plain twin; returns the largest error at stablelm widths."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_bf16 = 0.0
    for b, s, h, kv, d, window, blk, dtype, atol, rtol, label in FLASH_CASES:
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        ref = plain_bshd(q, k, v, True, window, blk)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == q.shape, f"{label}: {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref.float(), atol=atol, rtol=rtol)
        print(f"[kernel] {label}: B={b} S={s} H={h} KV={kv} D={d} window={window} "
              f"{str(dtype).split('.')[-1]} max_abs_err={err:.3e} (atol {atol}, rtol {rtol}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kernel disagrees with its plain twin: {label}")
        if dtype == torch.bfloat16 and h == 32:
            worst_bf16 = max(worst_bf16, err)
    for s, d, dtype, atol, rtol in BIDIR_CASES:
        q, k, v = (torch.randn((1, s, 4, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
        out = ops.flash_attention(q, k[:, :, :2], v[:, :, :2], causal=False)
        ref = plain_bshd(q, k[:, :, :2], v[:, :, :2], False, 0, 128)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref.float(), atol=atol, rtol=rtol)
        print(f"[kernel] bidirectional S={s} D={d} GQA group 2 {str(dtype).split('.')[-1]} "
              f"max_abs_err={err:.3e} (atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}")
        check(ok, f"bidirectional case S={s} D={d} {dtype} disagrees")
    return worst_bf16


def wkv_inputs(b: int, t: int, h: int, k: int, gen: torch.Generator, nonzero_s0: bool = True,
               logw: float | None = None) -> tuple[torch.Tensor, ...]:
    """(r, k, v, logw, u, s0) on the card, on the kernel's (B*H, T, K)
    layout, with a nonzero bonus u of its own in every row. r is scaled by
    K^-0.5, as a query is, so outputs stay O(1) at K = 64 and the absolute
    tolerance measures rounding, not the outputs' size."""
    bh = b * h

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, kk, v = randn(bh, t, k) * k**-0.5, randn(bh, t, k), randn(bh, t, k)
    lw = -torch.exp(randn(bh, t, k)) if logw is None else torch.full((bh, t, k), logw, device="cuda")
    u = randn(bh, 1, k) * 0.2
    s0 = randn(bh, k, k) if nonzero_s0 else torch.zeros((bh, k, k), device="cuda")
    return r, kk, v, lw, u, s0


def phase_wkv_cases() -> float:
    """The WKV kernel against its plain twin; returns the largest error."""
    from repro_torch.kernels import rwkv6 as wkv

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for b, t, h, k, chunk, nonzero_s0, logw, label in WKV_CASES:
        args = wkv_inputs(b, t, h, k, gen, nonzero_s0, logw)
        out, s_final = wkv.rwkv6_cuda(*args)
        ref_out, ref_s = wkv.rwkv6_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        check(out.shape == (b * h, t, k) and s_final.shape == (b * h, k, k),
              f"{label}: {tuple(out.shape)} {tuple(s_final.shape)}")
        errs = [(x - y).abs().max().item() for x, y in ((out, ref_out), (s_final, ref_s))]
        ok = all(bool(torch.isfinite(x).all()) and torch.allclose(x, y, atol=WKV_ATOL, rtol=WKV_RTOL)
                 for x, y in ((out, ref_out), (s_final, ref_s)))
        print(f"[wkv] {label}: B={b} T={t} H={h} K=V={k} chunk={chunk} f32 max_abs_err "
              f"out {errs[0]:.3e} s_final {errs[1]:.3e} (atol {WKV_ATOL}, rtol {WKV_RTOL}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"WKV kernel disagrees with its plain twin: {label}")
        worst = max(worst, *errs)
    return worst


def mamba_inputs(b: int, t: int, di: int, n: int, gen: torch.Generator, nonzero_h0: bool = True,
                 draw: str = "reference",
                 x_dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, ...]:
    """(dt, B, C, A, x, h0) on the card. ``reference``: as the reference's
    tests draw them, dt = softplus of a normal, A = -exp(0.5 * normal).
    ``slow decay``: jamba's init, A = -(1..N) and dt log-uniform in
    [1e-3, 1e-1] (``dt_bias_init``), so exp(dt * A) reaches 0.999.
    ``deep underflow``: A = -(1..N) and the reference's dt times 30, so
    dt * |A| * log2(e) > 127 for most n; x over 30 keeps dt * x at the
    reference draw's size. x is then cast to ``x_dtype``."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dt = torch.nn.functional.softplus(randn(b, t, di))
    bm, cm = randn(b, t, n), randn(b, t, n)
    a = -torch.exp(randn(di, n) * 0.5)
    x = randn(b, t, di)
    h0 = randn(b, di, n) if nonzero_h0 else torch.zeros((b, di, n), device="cuda")
    if draw != "reference":
        a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").repeat(di, 1)
    if draw == "slow decay":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(torch.rand((b, t, di), generator=gen, device="cuda") * (hi - lo) + lo)
    elif draw == "deep underflow":
        dt, x = dt * 30.0, x / 30.0
    else:
        check(draw == "reference", f"unknown draw {draw}")
    return dt, bm, cm, a, x.to(x_dtype), h0


def mamba_against_plain(args: tuple[torch.Tensor, ...], chunk: int) -> tuple[list[float], bool]:
    """Kernel and plain twin on the same inputs (x in its own type for
    both): the max errors of y and of the final state, and whether both
    are within the tolerance."""
    from repro_torch.kernels import mamba_scan as ms

    y, h = ms.mamba_scan_cuda(*args)
    ref_y, ref_h = ms.mamba_scan_plain(*args, chunk=chunk, d_block=args[0].shape[-1])
    torch.cuda.synchronize()
    pairs = ((y, ref_y), (h, ref_h))
    errs = [(u - v).abs().max().item() for u, v in pairs]
    ok = all(bool(torch.isfinite(u).all()) and torch.allclose(u, v, atol=MAMBA_ATOL, rtol=MAMBA_RTOL)
             for u, v in pairs)
    return errs, ok


def phase_mamba_cases() -> float:
    """The Mamba scan kernel against its plain twin; returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for b, t, di, n, chunk, nonzero_h0, draw, x_dtype, label in MAMBA_CASES:
        errs, ok = mamba_against_plain(
            mamba_inputs(b, t, di, n, gen, nonzero_h0, draw, x_dtype), chunk)
        print(f"[mamba] {label}: B={b} T={t} DI={di} N={n} chunk={chunk} {draw} draw, x "
              f"{str(x_dtype).split('.')[-1]} max_abs_err "
              f"y {errs[0]:.3e} h {errs[1]:.3e} (atol {MAMBA_ATOL}, rtol {MAMBA_RTOL}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"Mamba scan kernel disagrees with its plain twin: {label}")
        worst = max(worst, *errs)
    return worst


def phase_slice(arch: str, variant: str, prompt_lens: list[int],
                per_prefill: dict[str, int]) -> tuple[dict, dict]:
    """Serve ``arch`` at a real size; in the first run every kernel of
    ``kernel_modules()`` must launch ``per_prefill[name]`` times per prefill
    (0 for a kernel not named). Returns the launch counts and the stats."""
    from repro_torch.launch.serve import build_engine, make_requests, serve
    from repro_torch.runtime.store import MemoryStore
    from repro_torch.serve.batcher import result_tokens
    from repro_torch.models import count_params, model_spec

    tag = f"[slice {arch}]"
    mods = kernel_modules()
    t0 = time.perf_counter()
    engine = build_engine(arch, variant, max_len=max(prompt_lens) + NEW_TOKENS, seed=0)
    cfg = engine.cfg
    torch.cuda.synchronize()
    print(f"{tag} {variant}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {count_params(model_spec(cfg))} params in "
          f"{cfg.param_dtype}, built in {time.perf_counter() - t0:.1f} s")
    requests = make_requests(prompt_lens, cfg.vocab_size, NEW_TOKENS, seed=1)
    torch.cuda.reset_peak_memory_stats()

    runs = []
    for run in range(2):
        sink = MemoryStore()
        batches_before = engine.stats["batches"]
        if run == 0:
            for mod in mods.values():
                mod.launches = 0
        seconds = serve(engine, requests, 4, sink)
        if run == 0:
            counts = {name: mod.launches for name, mod in mods.items()}
            prefills = engine.stats["batches"] - batches_before
            want = {name: per_prefill.get(name, 0) * prefills for name in mods}
            print(f"{tag} kernel launches {counts} over {prefills} prefills "
                  f"({cfg.num_layers} layers; want {want})")
            check(prefills > 0 and counts == want,
                  f"kernel launches {counts} on the {arch} path, want {want}")
        outs = [result_tokens(sink, "serve", r["request_id"]) for r in requests]
        for o in outs:
            check(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o),
                  f"bad output {o}")
        n_tok = len(requests) * NEW_TOKENS
        print(f"{tag} run {run}: {len(requests)} requests, {n_tok} tokens, per batch "
              f"{[round(x, 4) for x in seconds]} s, {n_tok / sum(seconds):.1f} tokens/s")
        runs.append((outs, seconds))
    check(runs[0][0] == runs[1][0], "greedy output differs between two runs")
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} greedy output identical across runs; first request: {runs[0][0][0]}")
    print(f"{tag} max_memory_allocated {peak} bytes")
    stats = {"requests": len(requests), "tokens": len(requests) * NEW_TOKENS,
             "batch_s": runs[1][1], "tokens_per_s": len(requests) * NEW_TOKENS / sum(runs[1][1]),
             "peak_bytes": peak}
    stats.update(breakdown(engine, requests[:4], tag))
    del engine
    torch.cuda.empty_cache()
    return counts, stats


def breakdown(engine, requests: list[dict], tag: str) -> dict:
    """Where one batch's time goes: prefill and decode wall times, then a
    profiler window for the device's busy share and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve
    from repro_torch.runtime.store import MemoryStore
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.batcher import pad_prompts

    tokens = torch.as_tensor(pad_prompts(requests), dtype=torch.long, device="cuda")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(engine.params, engine.cfg, {"tokens": tokens}, engine.max_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = logits.argmax(-1)
        for pos in range(tokens.shape[1], tokens.shape[1] + NEW_TOKENS - 1):
            logits, cache = decode_step(engine.params, engine.cfg, tok, cache, pos)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    prefill_s, decode_step_s = t1 - t0, (t2 - t1) / (NEW_TOKENS - 1)
    print(f"{tag} breakdown: B={tokens.shape[0]} S={tokens.shape[1]}: prefill {prefill_s:.4f} s, "
          f"decode {decode_step_s * 1e3:.3f} ms/step")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(engine, requests, len(requests), MemoryStore())
        wall_s = time.perf_counter() - t0
    kernels = sorted(
        ((e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[2])
    busy_s = sum(r[2] for r in kernels) / 1e6
    if not kernels:
        print(f"{tag} profiler recorded no device time: busy share not measured")
        return {"prefill_s": prefill_s, "decode_step_s": decode_step_s}
    print(f"{tag} profiled batch: wall {wall_s:.4f} s, device busy {busy_s:.4f} s, "
          f"idle share {1 - busy_s / wall_s:.4f} (profiler overhead included)")
    port = ("flash_fwd_", "wkv6_fwd_kernel", "mamba_scan_fwd_kernel")  # the port's kernels
    ours = [r for r in kernels[8:] if any(name in r[0] for name in port)]  # if not on top
    for name, count, us in kernels[:8] + ours:
        print(f"{tag}   {us / 1e3:10.3f} ms {count:6d}x {us / 1e6 / busy_s:7.2%} {name[:90]}")
    return {"prefill_s": prefill_s, "decode_step_s": decode_step_s,
            "profiled_wall_s": wall_s, "profiled_busy_s": busy_s}


def reseed_rwkv(params: dict, gen: torch.Generator) -> None:
    """u, mu and mu_x init to zeros; seeded values exercise the bonus and
    the mixes."""
    mixer = params["groups"]["b0"]["mixer"]
    mixer["u"] = torch.randn(mixer["u"].shape, generator=gen) * 0.5
    for name in ("mu", "mu_x"):
        mixer[name] = torch.rand(mixer[name].shape, generator=gen)


def reseed_jamba(params: dict, gen: torch.Generator) -> None:
    """conv_b and d_skip init to zeros and ones; seeded values exercise the
    conv bias and the skip scale of every Mamba block."""
    for block in params["groups"].values():
        mixer = block["mixer"]
        if "conv_b" in mixer:
            mixer["conv_b"] = torch.randn(mixer["conv_b"].shape, generator=gen) * 0.5
            mixer["d_skip"] = torch.rand(mixer["d_skip"].shape, generator=gen) + 0.5


def phase_cross_device(arch: str, variant: str, t: int, reseed=None) -> None:
    """A smoke config in f32 on the card (kernels) against the CPU (plain
    twins), on the same weights: logits and greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, model_spec
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch, variant).copy(
        param_dtype="float32", compute_dtype="float32", use_pallas=True)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    if reseed is not None:
        reseed(params, torch.Generator().manual_seed(4))
    tokens = torch.randint(0, cfg.vocab_size, (2, t), generator=torch.Generator().manual_seed(1))
    on_cpu = ServeEngine(cfg, params, max_len=t + 24, device="cpu")
    on_gpu = ServeEngine(cfg, params, max_len=t + 24, device="cuda")
    with torch.inference_mode():
        lc, _ = forward(on_cpu.params, cfg, {"tokens": tokens})
        lg, _ = forward(on_gpu.params, cfg, {"tokens": tokens.cuda()})
    err = (lg.cpu() - lc).abs().max().item()
    ok = torch.allclose(lg.cpu(), lc, atol=5e-3, rtol=1e-3)
    print(f"[cross] {arch} {variant} f32, T={t}: logits cuda vs cpu max_abs_err={err:.3e} "
          f"(atol 5e-3, rtol 1e-3) {'ok' if ok else 'FAIL'}")
    check(ok, f"{arch} logits differ between the card and the CPU")
    tc = on_cpu.generate(tokens.numpy(), max_new_tokens=NEW_TOKENS)
    tg = on_gpu.generate(tokens.numpy(), max_new_tokens=NEW_TOKENS)
    print(f"[cross] {arch} greedy tokens identical: {(tc == tg).all()}")
    check((tc == tg).all(), f"{arch} greedy tokens differ between the card and the CPU")


def wkv_bound(bh: int, t: int, dk: int, dv: int, chunk: int) -> tuple[float, int, float, int]:
    """(ms, operations, ms, bytes): the least time for the operations at the
    float32 peak outside the tensor cores, and for the bytes (each input
    read once, each output written once) at the memory rate."""
    c, n = chunk, t // chunk
    per_chunk = (
        2 * c * dk  # cum, cum_prev
        + c * (c - 1) // 2 * dk * 5  # pairwise decay scores: sub, exp, 2 mul, add
        + 3 * c * dk  # the bonus diagonal
        + c * (c + 1) // 2 * dv * 2  # scores times v
        + 2 * c * dk + 2 * c * dk * dv  # r * exp(cum_prev), times S
        + 3 * c * dk + dk  # k * exp(cum_C - cum), exp(cum_C)
        + dk * dv * (1 + 2 * c)  # the state update
    )
    ops = bh * n * per_chunk
    nbytes = 4 * (bh * t * (3 * dk + dv) + bh * dk + bh * dk * dv  # r k logw v, u, s0
                  + bh * t * dv + bh * dk * dv)  # out, s_final
    return ops / PEAK_F32_FLOPS * 1e3, ops, nbytes / PEAK_BYTES_S * 1e3, nbytes


def phase_wkv_timing(worst_err: float, launches: int) -> tuple[dict, dict]:
    from repro_torch.kernels import rwkv6 as wkv

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for label, (b, t, h, k, chunk) in (("prefill", WKV_TIMING_SHAPE),
                                        ("prime prompt", WKV_SERVING_SHAPE)):
        args = wkv_inputs(b, t, h, k, gen)
        out, s_final = wkv.rwkv6_cuda(*args)
        ref_out, ref_s = wkv.rwkv6_plain(*args, chunk=chunk)
        err = max((out - ref_out).abs().max().item(), (s_final - ref_s).abs().max().item())
        check(torch.allclose(out, ref_out, atol=WKV_ATOL, rtol=WKV_RTOL)
              and torch.allclose(s_final, ref_s, atol=WKV_ATOL, rtol=WKV_RTOL),
              f"WKV timing shape {label} disagrees: {err}")
        t_ops, ops, t_bytes, nbytes = wkv_bound(b * h, t, k, k, chunk)
        kernel_ms, kernel_dev = timed(lambda: wkv.rwkv6_cuda(*args), 3, 20, 20,
                                      max(t_ops, t_bytes), f"WKV {label}")
        plain_ms = cuda_ms(lambda: wkv.rwkv6_plain(*args, chunk=chunk), 1, 3)
        print(f"[time] WKV {label}: B={b} T={t} H={h} K=V={k} chunk={chunk} f32: kernel "
              f"{kernel_ms:.4f} ms (device {kernel_dev:.4f} ms, {kernel_dev / t * 1e3:.3f} us "
              f"per step), plain "
              f"{plain_ms:.4f} ms, no library call; bound "
              f"{max(t_ops, t_bytes):.4f} ms ({ops} ops -> {t_ops:.4f} ms, {nbytes} bytes -> "
              f"{t_bytes:.4f} ms); max_abs_err {err:.3e}")
        rows[label] = {"shape": [b, t, h, k, chunk], "ms": kernel_ms, "device_ms": kernel_dev,
                       "plain_ms": plain_ms, "us_per_step": kernel_dev / t * 1e3,
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes", "err": err}
    main = rows["prefill"]
    return {
        "name": "rwkv6_wkv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:23",
        "launches": launches,
        "max_abs_err": max(worst_err, *(r["err"] for r in rows.values())),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes WKV-6
    }, rows["prime prompt"]


def mamba_bound(b: int, t: int, di: int, n: int,
                x_bytes: int = 4) -> tuple[float, int, float, int, int]:
    """(ms, operations, ms, bytes, exponentials) of the scan: the least time
    for about 7 float32 operations per (b, t, d, n) (multiply, exp,
    multiply, multiply-add into h, multiply-add into y) at the float32 peak
    outside the tensor cores, and for the bytes (each input read once, x at
    ``x_bytes`` an element, each output written once) at the memory rate."""
    ops = 7 * b * t * di * n
    nbytes = 4 * (2 * b * t * di + 2 * b * t * n + di * n + 2 * b * di * n) + x_bytes * b * t * di
    return ops / PEAK_F32_FLOPS * 1e3, ops, nbytes / PEAK_BYTES_S * 1e3, nbytes, b * t * di * n


def mufu_floor_ms(exps: int) -> float:
    """The least time for ``exps`` exponentials all on the special-function
    unit: exps / (SMs x 16 a clock) at the card's largest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (sms * MUFU_PER_CLOCK) / (float(smi("clocks.max.sm")) * 1e6) * 1e3


def phase_mamba_timing(worst_err: float, launches: int) -> tuple[dict, dict]:
    from repro_torch.kernels import mamba_scan as ms

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    shapes = [("prefill", MAMBA_TIMING_SHAPE, torch.float32),
              *((label, shape, torch.float32) for label, shape in MAMBA_SERVING_SHAPES.items()),
              *((f"{label} bf16 x", shape, torch.bfloat16)
                for label, shape in MAMBA_SERVING_SHAPES.items())]
    for label, (b, t, di, n, chunk), x_dtype in shapes:
        args = mamba_inputs(b, t, di, n, gen, nonzero_h0=False, x_dtype=x_dtype)
        errs, ok = mamba_against_plain(args, chunk)
        check(ok, f"Mamba timing shape {label} disagrees: {errs}")
        t_ops, ops, t_bytes, nbytes, exps = mamba_bound(b, t, di, n, x_dtype.itemsize)
        kernel_ms, kernel_dev = timed(lambda: ms.mamba_scan_cuda(*args), 3, 20, 20,
                                      max(t_ops, t_bytes), f"Mamba {label}")
        plain_ms = cuda_ms(lambda: ms.mamba_scan_plain(*args, chunk=chunk, d_block=512), 1, 2)
        t_mufu = mufu_floor_ms(exps)
        print(f"[time] Mamba {label}: B={b} T={t} DI={di} N={n} chunk={chunk} x "
              f"{str(x_dtype).split('.')[-1]}: kernel {kernel_ms:.4f} ms (device {kernel_dev:.4f} "
              f"ms, {kernel_dev / t * 1e3:.3f} us per step), plain {plain_ms:.4f} ms, no library "
              f"call; bound {max(t_ops, t_bytes):.4f} ms ({ops} ops -> {t_ops:.4f} ms, {nbytes} "
              f"bytes -> {t_bytes:.4f} ms); MUFU floor {t_mufu:.4f} ms ({exps} exponentials); "
              f"max_abs_err {max(errs):.3e}")
        rows[label] = {"shape": [b, t, di, n, chunk], "x": str(x_dtype).split(".")[-1],
                       "ms": kernel_ms, "device_ms": kernel_dev, "plain_ms": plain_ms,
                       "us_per_step": kernel_dev / t * 1e3, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "mufu_floor_ms": t_mufu, "err": max(errs)}
    main = rows.pop("prefill")
    return {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:24",
        "launches": launches,
        "max_abs_err": max(worst_err, main["err"], *(r["err"] for r in rows.values())),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no PyTorch call computes the selective scan
    }, rows


def flash_timing_row(label: str, shape: tuple[int, ...], gen: torch.Generator,
                     plain_iters: int) -> dict:
    """B1 in bf16, causal, at ``shape`` = (B, S, H, KV, D) on the kernel's
    (B*H, S, D) layout: kernel, plain twin and SDPA (the same function on
    (B, H, S, D), GQA by ``enable_gqa``), beside the bound. Kernel and SDPA
    are timed twice: by CUDA events over back-to-back calls, and by their
    device time alone."""
    from repro_torch.kernels import flash_attention as fa

    b, s, h, kv, d = shape
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b * kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    group = h // kv
    out = fa.flash_attention_cuda(q, k, v, group=group, causal=True)
    ref = fa.flash_attention_plain(q, k, v, group=group, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.allclose(out.float(), ref.float(), atol=3e-2, rtol=3e-2),
          f"flash timing shape {label} disagrees: {err}")
    flops = 4 * b * h * d * s * (s + 1) / 2  # q.k and p.v over the causal pairs
    nbytes = 2 * b * s * d * (2 * h + 2 * kv)  # q, k, v read once and o written once, bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    kernel_ms, kernel_dev = timed(
        lambda: fa.flash_attention_cuda(q, k, v, group=group, causal=True), 3, 20, 50,
        max(t_ops, t_bytes), f"flash {label}")
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, group=group, causal=True), 1,
                       plain_iters)
    q4, k4, v4 = q.view(b, h, s, d), k.view(b, kv, s, d), v.view(b, kv, s, d)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=group > 1)

    library_ms, library_dev = timed(sdpa, 3, 20, 50, max(t_ops, t_bytes), f"sdpa {label}")
    print(f"[time] flash {label}: B={b} S={s} H={h} KV={kv} D={d} bf16 causal: kernel "
          f"{kernel_ms:.4f} ms (device {kernel_dev:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms (device {library_dev:.4f} ms); bound {max(t_ops, t_bytes):.4f} ms "
          f"({flops:.4g} ops -> {t_ops:.4f} ms, {nbytes} bytes -> {t_bytes:.4f} ms); "
          f"{flops / kernel_dev / 1e9:.1f} TFLOP/s on the device; max_abs_err {err:.3e}")
    return {"shape": list(shape), "ms": kernel_ms, "device_ms": kernel_dev, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "err": err}


def phase_timing(worst_err: float, launches: int) -> tuple[dict, dict]:
    gen = torch.Generator(device="cuda").manual_seed(2)
    main = flash_timing_row("prefill", TIMING_SHAPE, gen, 5)
    serving = {label: flash_timing_row(label, shape, gen, 20)
               for label, shape in FLASH_SERVING_SHAPES.items()}
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": launches,
        "max_abs_err": max(worst_err, main["err"], *(r["err"] for r in serving.values())),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }, serving


def grad_fn_names(t: torch.Tensor) -> list[str]:
    """The autograd nodes behind ``t``, nearest first."""
    names, seen, todo = [], set(), [t.grad_fn]
    while todo:
        node = todo.pop(0)
        if node is not None and id(node) not in seen:
            seen.add(id(node))
            names.append(type(node).__name__)
            todo += [n for n, _ in node.next_functions]
    return names


def phase_grad() -> dict:
    """Flash attention under grad on the card: ``ops.flash_attention`` goes
    through ``FlashAttentionFn``, launches the kernel once and returns its
    output; dq/dk/dv match autograd through the plain twin on the card.
    The WKV and scan kernels refuse grad. Returns the worst error and the
    backward's time at stablelm's training shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6 as wkv

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = {c[-1]: c for c in FLASH_CASES}
    worst = 0.0
    for label in GRAD_CASES:
        b, s, h, kv, d, window, blk, dtype, atol, rtol, _ = cases[label]
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda").to(dtype)
                   for n in (h, kv, kv))
        w = torch.randn((b, s, h, d), generator=gen, device="cuda")
        live = [t.clone().requires_grad_() for t in (q, k, v)]
        before = fa.launches
        out = ops.flash_attention(*live, causal=True, window=window)
        check(fa.launches == before + 1 and "FlashAttentionFnBackward" in grad_fn_names(out),
              f"{label}: {fa.launches - before} launches, graph {grad_fn_names(out)}")
        with torch.no_grad():
            kernel_out = ops.flash_attention(q, k, v, causal=True, window=window)
        check(torch.equal(out.detach(), kernel_out), f"{label}: the forward is not the kernel's")
        got = torch.autograd.grad((out.float() * w).sum(), live)
        check(fa.launches == before + 2, f"{label}: the backward launched the kernel")
        ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = plain_bshd(*ref_in, True, window, blk)
        want = torch.autograd.grad((ref.float() * w).sum(), ref_in)
        torch.cuda.synchronize()
        errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, want)]
        ok = all(g.dtype == dtype and bool(torch.isfinite(g.float()).all())
                 and torch.allclose(g.float(), r.float(), atol=atol, rtol=rtol)
                 for g, r in zip(got, want))
        print(f"[grad] {label}: B={b} S={s} H={h} KV={kv} D={d} window={window} "
              f"{str(dtype).split('.')[-1]} max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} "
              f"dv {errs[2]:.3e} (atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}")
        check(ok, f"FlashAttentionFn gradients disagree with the plain twin's: {label}")
        worst = max(worst, *errs)
    print(f"[grad] largest gradient error against autograd through the plain twin: {worst:.3e}")

    r = torch.randn((2, 16, 8), device="cuda", requires_grad=True)
    wkv_args = (r, *(torch.randn((2, 16, 8), device="cuda") for _ in range(2)),
                -torch.rand((2, 16, 8), device="cuda"), torch.zeros((2, 1, 8), device="cuda"),
                torch.zeros((2, 8, 8), device="cuda"))
    dt = torch.rand((1, 16, 8), device="cuda", requires_grad=True)
    scan_args = (dt, torch.randn((1, 16, 4), device="cuda"), torch.randn((1, 16, 4), device="cuda"),
                 -torch.rand((8, 4), device="cuda"), torch.randn((1, 16, 8), device="cuda"),
                 torch.zeros((1, 8, 4), device="cuda"))
    for name, fn, args in (("rwkv6_cuda", wkv.rwkv6_cuda, wkv_args),
                           ("mamba_scan_cuda", ms.mamba_scan_cuda, scan_args)):
        try:
            fn(*args)
        except RuntimeError as e:
            check("queue B" in str(e), f"{name}: {e}")
            print(f"[grad] {name} under grad raises: {str(e)[:80]}...")
        else:
            check(False, f"{name} returned a tensor without a gradient under grad")

    # the backward of one attention layer at stablelm's training shape (one
    # microbatch: B=2, S=1024): the kernel forward, then the recomputation
    # through the twin and its gradients
    b, s, h, d = TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 32, 80
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    g_out = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)

    def fwd():
        return ops.flash_attention(q, k, v, causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), g_out)

    fwd_ms = cuda_ms(fwd, 2, 10)
    both_ms = cuda_ms(fwd_bwd, 2, 10)
    print(f"[grad] stablelm training shape B={b} S={s} H={h} D={d} bf16: forward (kernel) "
          f"{fwd_ms:.4f} ms, forward + backward (recomputation through the plain twin) "
          f"{both_ms:.4f} ms, so the backward {both_ms - fwd_ms:.4f} ms a layer")
    return {"worst_err": worst, "fwd_ms": fwd_ms, "bwd_ms": both_ms - fwd_ms}


def host_copy(tree: dict) -> list[torch.Tensor]:
    from repro_torch.tree import leaves

    return [t.detach().to("cpu", copy=True) for t in leaves(tree)]


def phase_train_full(grad_stats: dict) -> tuple[dict, dict]:
    """stablelm-3b at full width and depth in its own bf16: 3 steps of
    ``make_train_step`` (AdamW, remat "full", B=4, S=1024, 2 microbatches)
    on ``SyntheticTokens``, with the launch count of every step asserted;
    then a profiled step and a breakdown. Returns the launch counts of the
    3 steps and the stats."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticTokens, to_device
    from repro_torch.models import count_params, init_params, model_spec
    from repro_torch.models.model import dtype_of
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (
        init_state, loss_fn, make_train_step, split_microbatches,
    )
    from repro_torch.tree import leaves_with_names, rebuild

    tag = "[train-full]"
    mods = kernel_modules()
    cfg = get_config("stablelm-3b", "full")
    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16", f"config {cfg.remat} {cfg.param_dtype}")
    tcfg = TrainConfig(optimizer="adamw", learning_rate=1e-2, warmup_steps=0,
                       total_steps=100, microbatches=TRAIN_MICRO)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_state(init_params(model_spec(cfg), gen, dtype_of(cfg.param_dtype), "cuda"), tcfg)
    torch.cuda.synchronize()
    n_params = count_params(model_spec(cfg))
    print(f"{tag} stablelm-3b full: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} params in {cfg.param_dtype}, remat {cfg.remat}, AdamW, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}, {TRAIN_MICRO} microbatches; state built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_params == 2_795_443_200, f"{n_params} params")
    before = host_copy(state["params"])
    data = SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    step_fn = make_train_step(cfg, tcfg)
    per_step = cfg.num_layers * 2 * TRAIN_MICRO  # forward + remat recomputation, per microbatch
    torch.cuda.reset_peak_memory_stats()
    counts = {name: 0 for name in mods}
    losses, seconds = [], []
    for step in range(TRAIN_STEPS):
        batch = to_device(split_microbatches(data.batch_at(step), TRAIN_MICRO), "cuda")
        for mod in mods.values():
            mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        got = {name: mod.launches for name, mod in mods.items()}
        want = {name: per_step if name == "flash_attention" else 0 for name in mods}
        check(got == want, f"step {step}: kernel launches {got}, want {want}")
        counts = {name: counts[name] + got[name] for name in mods}
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m)
        print(f"{tag} step {step}: ce {m['ce']:.4f} grad_norm {m['grad_norm']:.4f} lr {m['lr']:.3g} "
              f"{seconds[-1]:.4f} s, {TRAIN_BATCH * TRAIN_SEQ / seconds[-1]:.1f} tokens/s, "
              f"launches {got}")
        check(all(math.isfinite(v) for v in m.values()), f"step {step}: non-finite metrics {m}")
    peak = torch.cuda.max_memory_allocated()
    ln_v = math.log(cfg.vocab_size)
    check(ln_v - 1 <= losses[0]["ce"] <= ln_v + 2,
          f"first CE {losses[0]['ce']} outside [ln V - 1, ln V + 2] = [{ln_v - 1}, {ln_v + 2}]")
    after = host_copy(state["params"])
    names = [n for n, _ in leaves_with_names(state["params"])]
    unchanged = [n for n, a, b in zip(names, before, after) if torch.equal(a, b)]
    check(not unchanged, f"parameter leaves unchanged after {TRAIN_STEPS} steps: {unchanged}")
    del before, after
    print(f"{tag} first CE {losses[0]['ce']:.4f} (ln V = {ln_v:.4f}); all {len(names)} parameter "
          f"leaves changed; launches over {TRAIN_STEPS} steps {counts} ({per_step} a step); "
          f"max_memory_allocated {peak} bytes")

    # a profiled step: device busy time, idle share, B1's forward and the
    # recomputation through the twin (the device time under its backward)
    batch = to_device(split_microbatches(data.batch_at(TRAIN_STEPS), TRAIN_MICRO), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = sorted(((e.key, e.count, e.self_device_time_total) for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda r: -r[2])
    stats = {"step_s": seconds, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / min(seconds),
             "steps_per_s": 1 / min(seconds), "peak_bytes": peak,
             "ce": [m["ce"] for m in losses], "grad_norm": [m["grad_norm"] for m in losses]}
    if kernels:
        busy_s = sum(r[2] for r in kernels) / 1e6
        b1_ms = sum(r[2] for r in kernels if "flash_fwd_" in r[0]) / 1e3
        b1_n = sum(r[1] for r in kernels if "flash_fwd_" in r[0])
        # the autograd engine's event for each FlashAttentionFn backward
        # (the node's own event nests inside it: counting both doubles)
        recompute_ms = sum(e.device_time_total for e in events if e.key == (
            "autograd::engine::evaluate_function: FlashAttentionFnBackward")) / 1e3
        print(f"{tag} profiled step: wall {wall_s:.4f} s, device busy {busy_s:.4f} s, idle share "
              f"{1 - busy_s / wall_s:.4f} (profiler overhead included); B1 forward {b1_n}x "
              f"{b1_ms:.3f} ms; recomputation through the twin under FlashAttentionFnBackward "
              f"{recompute_ms:.3f} ms")
        for name, count, us in kernels[:10]:
            print(f"{tag}   {us / 1e3:10.3f} ms {count:6d}x {us / 1e6 / busy_s:7.2%} {name[:90]}")
        stats.update(profiled_wall_s=wall_s, profiled_busy_s=busy_s, b1_fwd_ms=b1_ms,
                     b1_fwd_launches=b1_n, b1_recompute_device_ms=recompute_ms)
    else:
        print(f"{tag} profiler recorded no device time: busy share not measured")

    # breakdown of one microbatch's work, each piece timed alone after a
    # synchronize: forward (with remat), backward (the remat recomputation,
    # the gradients, B1's recomputation through the twin), optimizer update
    mb = {k: v[0] for k, v in batch.items()}
    live = {n: p.detach().requires_grad_() for n, p in leaves_with_names(state["params"])}
    params = state["params"]
    tree = rebuild(params, list(live.values()))
    for _ in range(2):  # the second pass is the one reported
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(tree, cfg, tcfg, mb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, list(live.values()))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del loss
    del tree, live
    gtree = rebuild(params, list(grads))
    del grads
    opt.clip_by_global_norm(gtree, tcfg.grad_clip)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    opt.opt_update(params, gtree, state["opt"], state["step"], tcfg)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    del gtree
    recompute_s = grad_stats["bwd_ms"] * cfg.num_layers / 1e3
    breakdown = {"forward_s": t1 - t0, "backward_s": t2 - t1, "clip_s": t3 - t2,
                 "update_s": t4 - t3, "b1_recompute_s_est": recompute_s}
    print(f"{tag} breakdown of one microbatch (B={TRAIN_BATCH // TRAIN_MICRO}): forward "
          f"{t1 - t0:.4f} s, backward {t2 - t1:.4f} s (B1's recomputation through the twin: "
          f"{cfg.num_layers} x {grad_stats['bwd_ms']:.3f} ms = {recompute_s:.4f} s by [grad]'s "
          f"timing), clipping {t3 - t2:.4f} s; optimizer update (once a step) {t4 - t3:.4f} s")
    stats["breakdown"] = breakdown
    del state, batch, params
    torch.cuda.empty_cache()
    return counts, stats


def phase_continuum() -> dict:
    """The reference's main path on the card at smoke size in float32,
    through ``runtime.train_loop`` against a ``MemoryStore``: prepare_data,
    train (straight; and crashing at step 3, then resumed from
    latest.json), evaluate, and the train→serve hand-off behind the batch
    handler. Deterministic algorithms make the straight and resumed runs
    comparable at the reference test's atol 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import train_loop as tl
    from repro_torch.runtime.store import MemoryStore
    from repro_torch.serve.batcher import make_batch_handler
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import leaves_with_names

    tag = "[continuum]"
    mods = kernel_modules()
    store = MemoryStore()
    data = tl.prepare_data(store, "smoke", shards=2, tokens_per_shard=1024)
    print(f"{tag} prepare_data: {data}")
    torch.use_deterministic_algorithms(True)
    try:
        for mod in mods.values():
            mod.launches = 0
        straight, trained = tl.train_run(store, "smoke", device="cuda", run="straight",
                                         **CONTINUUM_KW)
        counts = {name: mod.launches for name, mod in mods.items()}
        layers = get_config("stablelm-3b", "smoke").num_layers
        want = {name: CONTINUUM_KW["steps"] * layers * 2 if name == "flash_attention" else 0
                for name in mods}  # each layer's forward and its remat recomputation
        check(counts == want, f"train launches {counts}, want {want}")
        print(f"{tag} train straight: {straight}; launches {counts}")
        try:
            tl.train(store, "smoke", device="cuda", run="resumed", die_at_step=3, **CONTINUUM_KW)
            check(False, "die_at_step=3 did not crash")
        except tl.SimulatedCrash as e:
            latest = tl.CheckpointManager(store, "smoke", run="resumed").latest_step()
            print(f"{tag} crashed: {e}; latest checkpoint step {latest}")
            check(latest == 1, f"latest checkpoint {latest} after the crash, want 1")
        resumed = tl.train(store, "smoke", device="cuda", run="resumed", **CONTINUUM_KW)
        print(f"{tag} train resumed: {resumed}")
        ev = tl.evaluate(store, "smoke", device="cuda", arch="stablelm-3b", run="resumed",
                         batch=CONTINUUM_KW["batch"], seq_len=CONTINUUM_KW["seq_len"])
        print(f"{tag} evaluate: {ev}")
        check(ev[0]["step"] == CONTINUUM_KW["steps"] - 1 and math.isfinite(ev[0]["eval_ce"]),
              f"evaluate {ev}")
        engines = {run: tl.serve_engine(store, "smoke", arch="stablelm-3b", max_len=64, run=run,
                                        device="cuda") for run in ("straight", "resumed")}
    finally:
        torch.use_deterministic_algorithms(False)
    exact = all(torch.equal(a, b) for (_, a), (_, b) in
                zip(leaves_with_names(engines["straight"].params),
                    leaves_with_names(trained["params"])))
    check(exact, "the straight run's checkpoint does not restore its in-memory params exactly")
    worst = max((a - b).abs().max().item() for (_, a), (_, b) in
                zip(leaves_with_names(engines["straight"].params),
                    leaves_with_names(engines["resumed"].params)))
    print(f"{tag} params straight vs resumed: max_abs_err {worst:.3e} (atol 1e-6)")
    check(worst <= 1e-6, f"straight and resumed runs differ by {worst}")
    in_memory = ServeEngine(engines["resumed"].cfg, trained["params"], max_len=64, device="cuda")
    rng = np.random.default_rng(5)
    requests = [{"request_id": f"c{i}", "prompt": rng.integers(0, 256, n).tolist(),
                 "max_new_tokens": 8} for i, n in enumerate((5, 12, 9, 16))]
    handler = make_batch_handler(engines["resumed"], store, "smoke")
    check(handler(None, packed_args=requests) == [len(requests)], "batch handler")
    from repro_torch.serve.batcher import pad_prompts, result_tokens

    served = [result_tokens(store, "smoke", r["request_id"]) for r in requests]
    want = in_memory.generate(pad_prompts(requests), max_new_tokens=8).tolist()
    print(f"{tag} served from the restored checkpoint: {served[0]} ...; identical to the "
          f"in-memory params' greedy tokens: {served == want}")
    check(served == want, "tokens from the restored checkpoint differ from the in-memory params'")
    return counts


def phase_continuum_process() -> dict:
    """``phase_continuum`` in a child process (``--continuum``) under
    ``CONTINUUM_ENV``; its output is passed on, and its last line holds
    the launch counts of its training run."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--continuum"],
                         env=dict(os.environ, **CONTINUUM_ENV), capture_output=True, text=True,
                         timeout=600)
    lines = res.stdout.splitlines()
    for line in lines[:-1]:
        print(line)
    if res.returncode != 0:
        print(res.stderr[-8000:], file=sys.stderr)
    check(res.returncode == 0 and bool(lines), f"[continuum] process exited {res.returncode}")
    print(f"[continuum] {time.perf_counter() - t0:.1f} s in its own process")
    return json.loads(lines[-1])


def phase_train_cross() -> dict:
    """stablelm smoke in float32, 3 steps on the card against the CPU from
    the same params and batches, for AdamW and Adafactor at 1 and 2
    microbatches. Returns the largest differences seen."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticTokens, to_device
    from repro_torch.models import init_params, model_spec
    from repro_torch.train.train_step import init_state, make_train_step, split_microbatches
    from repro_torch.tree import leaves_with_names, map_leaves

    cfg = get_config("stablelm-3b", "smoke").copy(param_dtype="float32", compute_dtype="float32")
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    data = SyntheticTokens(cfg, 4, 64, seed=1)
    worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0, "opt": 0.0}
    for optimizer in ("adamw", "adafactor"):
        for k in (1, 2):
            tcfg = TrainConfig(optimizer=optimizer, learning_rate=1e-3, warmup_steps=1,
                               total_steps=10, microbatches=k)
            states = {dev: init_state(map_leaves(lambda p: p.to(dev, copy=True), params), tcfg)
                      for dev in ("cpu", "cuda")}
            steps = {dev: make_train_step(cfg, tcfg) for dev in states}
            for i in range(3):
                host = data.batch_at(i)
                if k > 1:
                    host = split_microbatches(host, k)
                metrics = {}
                for dev in states:
                    states[dev], metrics[dev] = steps[dev](states[dev], to_device(host, dev))
                for key in ("loss", "grad_norm"):
                    a, b = float(metrics["cuda"][key]), float(metrics["cpu"][key])
                    err = abs(a - b)
                    check(err <= TRAIN_CROSS_ATOL + TRAIN_CROSS_RTOL * abs(b),
                          f"{optimizer} k={k} step {i} {key}: cuda {a} cpu {b}")
                    worst[key] = max(worst[key], err)
            for part in ("params", "opt"):
                pairs = zip(leaves_with_names(states["cuda"][part]),
                            leaves_with_names(states["cpu"][part]))
                for (name, a), (_, b) in pairs:
                    a = a.cpu()
                    err = (a - b).abs().max().item()
                    check(torch.allclose(a, b, atol=TRAIN_CROSS_ATOL, rtol=TRAIN_CROSS_RTOL),
                          f"{optimizer} k={k} {name}: cuda vs cpu max_abs_err {err}")
                    worst[part] = max(worst[part], err)
            print(f"[train-cross] {optimizer}, {k} microbatch(es), 3 steps: loss "
                  f"{float(metrics['cuda']['loss']):.6f} (cpu {float(metrics['cpu']['loss']):.6f}); "
                  f"worst so far {json.dumps(worst)}")
    print(f"[train-cross] cuda vs cpu within atol {TRAIN_CROSS_ATOL}, rtol {TRAIN_CROSS_RTOL}: "
          f"largest differences {json.dumps(worst)}")
    return worst


def reference_modules(modules) -> list[str]:
    """The names in ``modules`` (e.g. ``sys.modules``) of the reference
    package (``repro`` and ``repro.*``) and of JAX (any name starting with
    ``jax``), sorted: this process must hold none of them."""
    return sorted(n for n in modules if n == "repro" or n.startswith(("repro.", "jax")))


# The broker process. ColonyOS deploys the broker as a service of its own,
# which executors on any platform reach only through the signed JSON
# protocol over HTTP; so it runs here as a separate process, and this
# process reaches it only through the port's HttpTransport. The broker is
# the port's stdlib copy, ``repro_torch.broker``, which uses torch for
# nothing: the child registers the ``repro_torch`` package by its path
# without running its ``__init__`` (which warms torch's CPU ``exp``), so it
# loads neither torch nor any module of the reference. It verifies every
# signature (and shows that it refuses an unsigned request), runs the failsafe scanner and the generators' ticks every
# 0.1 s, prints its port, then what it imported, and waits to be killed.
BROKER_SOURCE = """\
import json, sys, threading, time, types
t0 = time.perf_counter()
pkg = types.ModuleType("repro_torch")
pkg.__path__ = [sys.argv[2]]
sys.modules["repro_torch"] = pkg
from repro_torch.broker import ColoniesHttpServer, standalone_server
srv = standalone_server(sys.argv[1])
http = ColoniesHttpServer(srv)
http.start()
srv.start_background(failsafe_interval=0.1)
print(http.port, flush=True)
tops = {n.split(".")[0] for n in sys.modules}
unsigned = srv.handle({"payloadtype": "colonystats", "payload": "{}", "identity": sys.argv[1]})
print(json.dumps({"refuses_unsigned": unsigned.get("status") == 403,
                  "start_s": time.perf_counter() - t0,
                  "torch_or_jax": sorted(tops & {"torch", "jax", "jaxlib"}),
                  "reference": sorted(tops & {"repro"})}), flush=True)
threading.Event().wait()
"""
COLONY = "h100"
# [executors-continuum]: the DAGs of tests/test_integration_continuum.py at
# their smoke size; the hand-off's training takes DAG 1's kwargs, so its
# attempt time bounds DAG 1's and sets DAG 1's lease (3x)
EXEC_TRAIN_KW = {"arch": "stablelm-3b", "steps": 4, "batch": 2, "seq_len": 16,
                 "checkpoint_every": 1}
EXEC_EVAL_BATCHES = 2  # evaluate's default eval_batches


class Broker:
    """The broker process (``BROKER_SOURCE``) and the port's signed HTTP
    client to it, with a server key and a colony key of this run."""

    def __init__(self) -> None:
        from repro_torch.core.client import Colonies
        from repro_torch.core.crypto import Crypto
        from repro_torch.core.http_transport import HttpTransport

        self.server_prv, self.colony_prv = Crypto.prvkey(), Crypto.prvkey()
        t0 = time.perf_counter()
        root = Path(__file__).resolve().parent
        self.proc = subprocess.Popen(
            [sys.executable, "-c", BROKER_SOURCE, Crypto.id(self.server_prv),
             str(root / "src" / "repro_torch")], cwd=root, stdout=subprocess.PIPE, text=True)
        try:
            port = self.proc.stdout.readline().strip()
            info = self.proc.stdout.readline().strip()
            self.start_s = time.perf_counter() - t0
            check(port.isdigit() and bool(info), f"the broker process printed {port!r}, {info!r}")
            self.info = json.loads(info)
        except BaseException:
            self.close()
            raise
        self.transport = HttpTransport("127.0.0.1", int(port))
        self.client = Colonies(self.transport)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def close(self) -> None:
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self.proc.stdout.close()


def phase_broker(broker: Broker) -> dict:
    """The broker is up, verifies signatures and imported neither torch nor
    jax; the colony is created with the server key; 20 signed
    ``colonystats`` calls give the mean round trip."""
    from repro_torch.core.crypto import Crypto

    tag = "[broker]"
    print(f"{tag} broker process {broker.proc.pid} on port {broker.transport.endpoints[0][1]}: "
          f"{json.dumps(broker.info)}; up after {broker.start_s:.3f} s")
    check(broker.info["refuses_unsigned"] is True, "the broker took an unsigned request")
    check(broker.info["torch_or_jax"] == [] and broker.info["reference"] == [],
          f"the broker process imported {broker.info['torch_or_jax'] + broker.info['reference']}")
    health = broker.transport.health()
    check(health.get("status") == "ok", f"/health answered {health}")
    broker.client.add_colony(COLONY, Crypto.id(broker.colony_prv), broker.server_prv)
    seconds = []
    for _ in range(20):
        t0 = time.perf_counter()
        stats = broker.client.stats(COLONY, broker.colony_prv)
        seconds.append(time.perf_counter() - t0)
    check(stats["executors"] == 0 and stats["waiting"] == 0, f"colonystats {stats}")
    t0 = time.perf_counter()
    for _ in range(20):
        Crypto.sign("colonystats", broker.colony_prv)
    sign_s = (time.perf_counter() - t0) / 20
    rtt = sum(seconds) / len(seconds)
    print(f"{tag} /health {health}; colony {COLONY!r} created; 20 signed colonystats: mean round "
          f"trip {rtt * 1e3:.3f} ms (min {min(seconds) * 1e3:.3f}, max {max(seconds) * 1e3:.3f}); "
          f"signing alone {sign_s * 1e3:.3f} ms")
    return {"start_s": broker.start_s, "rpc_mean_s": rtt, "rpc_min_s": min(seconds),
            "rpc_max_s": max(seconds), "sign_s": sign_s}


def serve_workflow() -> dict:
    """The workflow a serving generator fires: one ``generate_batch``."""
    return {"colonyname": COLONY,
            "functionspecs": [{"nodename": "batch", "funcname": "generate_batch",
                               "conditions": {"executortype": "h100-serve",
                                              "dependencies": []}}]}


def zero_launches(mods: dict) -> None:
    for mod in mods.values():
        mod.launches = 0


def phase_executors_continuum(broker: Broker) -> tuple[dict, dict]:
    """Both DAGs of tests/test_integration_continuum.py on the card, smoke
    size, float32, through the port's executors and the broker process.
    The hand-off first: a TrainerExecutor trains run "handoff", whose
    attempt time sets DAG 1's train lease (3x); a ServeExecutor restores
    it from CFS and serves a generator's batch, token for token as its
    engine's own generate. Then DAG 1: prepare_data on an edge executor,
    train on two trainers that both crash at step 3 on their first
    attempt, the failsafe, the resume, evaluate. Flash attention's
    launches are counted for the steps and batches that really ran."""
    from repro_torch.configs import get_config
    from repro_torch.core.fs import CFSClient, MemoryStorage
    from repro_torch.core.spec import FunctionSpec, WorkflowSpec
    from repro_torch.runtime import torch_executor as tx
    from repro_torch.serve.batcher import InferenceClient, pad_prompts

    tag = "[executors-continuum]"
    t_phase = time.perf_counter()
    mods = kernel_modules()
    layers = get_config("stablelm-3b", "smoke").num_layers
    client, prv = broker.client, broker.colony_prv
    storage = MemoryStorage()  # the blob store every executor here shares
    kw = dict(colony_prvkey=prv, device="cuda")
    running = []

    def start(ex):
        running.append(ex)
        ex.start(poll_timeout=0.2)
        return ex

    try:
        # ---- the hand-off: train, then serve the checkpoint behind a generator
        zero_launches(mods)
        trainer = start(tx.TrainerExecutor(client, COLONY, "h100-handoff", "h100-pod", storage,
                                           **kw))
        p = client.submit(FunctionSpec.from_dict({
            "conditions": {"colonyname": COLONY, "executortype": "h100-pod"},
            "funcname": "train", "kwargs": dict(EXEC_TRAIN_KW, run="handoff"),
            "maxexectime": 600}), prv)
        done = client.wait(p["processid"], prv, timeout=600)
        trainer.stop()
        check(done["state"] == "successful" and done["out"][0]["final_step"] == 3,
              f"hand-off train: {done['state']} {done['errors'] or done['out']}")
        attempt_s = (done["endtime"] - done["starttime"]) / 1e9
        lease = max(5, math.ceil(3 * attempt_s))
        print(f"{tag} hand-off train (4 steps, 4 checkpoints): {done['out'][0]}; attempt "
              f"{attempt_s:.3f} s from assign to close, so DAG 1's train lease is {lease} s")
        server = start(tx.ServeExecutor(client, COLONY, "h100-serve-handoff", "h100-serve",
                                        storage, arch="stablelm-3b", max_len=64, run="handoff",
                                        **kw))
        g = client.add_generator({"colonyname": COLONY, "name": "handoff-gen", "queuesize": 4,
                                  "timeout": 30.0, "workflow": serve_workflow()}, prv)
        infc = InferenceClient(client, CFSClient(client, storage, prv), COLONY, g["generatorid"],
                               prv)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 256, n).tolist() for n in (5, 12, 9, 16)]
        rids = [infc.submit(pr, max_new_tokens=8) for pr in prompts]
        served = [infc.wait(r, timeout=120) for r in rids]
        server.stop()
        handoff = {name: mod.launches for name, mod in mods.items()}
        check(server.engine.stats["batches"] == 1, f"hand-off batches {server.engine.stats}")
        direct = server.engine.generate(pad_prompts([{"prompt": pr} for pr in prompts]),
                                        max_new_tokens=8).tolist()
        print(f"{tag} served from the restored checkpoint through a generator: {served[0]} ...; "
              f"identical to the engine's own generate: {served == direct}")
        check(served == direct, "tokens served through the generator differ from generate's")
        # 4 steps x (forward + remat recomputation) x layers, then one prefill
        want = {name: EXEC_TRAIN_KW["steps"] * 2 * layers + layers
                if name == "flash_attention" else 0 for name in mods}
        print(f"{tag} hand-off launches {handoff} (want {want})")
        check(handoff == want, f"hand-off launches {handoff}, want {want}")

        # ---- DAG 1: prepare_data -> train (crash at step 3, failsafe, resume) -> evaluate
        data_ex = start(tx.DataExecutor(client, COLONY, "edge-1", "edge-data", storage, **kw))
        trainers = [start(tx.TrainerExecutor(client, COLONY, f"h100-{c}", "h100-pod", storage,
                                             die_at_step=3, **kw)) for c in "ab"]
        wf = WorkflowSpec.from_dict({"colonyname": COLONY, "functionspecs": [
            {"nodename": "prep", "funcname": "prepare_data",
             "kwargs": {"shards": 2, "tokens_per_shard": 256},
             "conditions": {"executortype": "edge-data", "dependencies": []},
             "maxexectime": 30},
            {"nodename": "train", "funcname": "train", "kwargs": dict(EXEC_TRAIN_KW, run="itest"),
             "conditions": {"executortype": "h100-pod", "dependencies": ["prep"]},
             "maxexectime": lease, "maxretries": 5},
            {"nodename": "eval", "funcname": "evaluate",
             "kwargs": {"arch": "stablelm-3b", "batch": 2, "seq_len": 16, "run": "itest",
                        "eval_batches": EXEC_EVAL_BATCHES},
             "conditions": {"executortype": "h100-pod", "dependencies": ["train"]},
             "maxexectime": 60},
        ]})
        zero_launches(mods)
        t0 = time.perf_counter()
        r = client.submit_workflow(wf, prv)
        procs = {q["spec"]["nodename"]: q for q in r["processes"]}
        done = client.wait(procs["eval"]["processid"], prv, timeout=3 * lease + 300)
        dag_s = time.perf_counter() - t0
        dag1 = {name: mod.launches for name, mod in mods.items()}
        for ex in (data_ex, *trainers):
            ex.stop()
        train_p = client.get_process(procs["train"]["processid"], prv)
        failed = [t.failed for t in trainers]
        print(f"{tag} DAG 1 in {dag_s:.3f} s: eval {done['state']} {done['out'] or done['errors']}; "
              f"train {train_p['state']}, retries {train_p['retries']}, out {train_p['out']}; "
              f"trainers failed {failed}, processed {[t.processed for t in trainers]}")
        check(done["state"] == "successful" and math.isfinite(done["out"][0]["eval_ce"]),
              f"evaluate: {done['state']} {done['errors']}")
        check(train_p["state"] == "successful" and train_p["retries"] >= 1
              and train_p["out"][0]["final_step"] == 3, f"train: {train_p}")
        check(sum(failed) in (1, 2), f"trainers failed {failed}, want 1 or 2 in all")
        # steps 0-2, then step 3 after the resume (a second crash comes
        # before step 3 runs), each forward + remat recomputation; then one
        # forward per eval batch
        want = {name: (4 * 2 + EXEC_EVAL_BATCHES) * layers if name == "flash_attention" else 0
                for name in mods}
        print(f"{tag} DAG 1 launches {dag1} (want {want})")
        check(dag1 == want, f"DAG 1 launches {dag1}, want {want}")
        check(broker.alive(), "the broker process died")
    finally:
        for ex in running:
            ex.stop()
    total = {name: handoff[name] + dag1[name] for name in mods}
    seconds = time.perf_counter() - t_phase
    print(f"{tag} {seconds:.1f} s")
    return total, {"train_attempt_s": attempt_s, "train_lease_s": lease, "dag1_s": dag_s,
                   "trainers_failed": failed, "train_retries": train_p["retries"],
                   "eval_ce": done["out"][0]["eval_ce"], "seconds": seconds}


def phase_executors_serve_full(broker: Broker) -> tuple[dict, dict]:
    """Full-width stablelm-3b (32 layers, float32 as the executors' config
    forces) in a ServeExecutor behind a generator of queuesize 4: 8 signed
    requests over HTTP in 2 batches, 32 flash attention launches a prefill,
    tokens equal to the engine's own generate on each batch; where the wall
    time goes."""
    from repro_torch.core.fs import CFSClient, MemoryStorage
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import count_params, model_spec, prefill
    from repro_torch.runtime import torch_executor as tx
    from repro_torch.serve.batcher import InferenceClient, pad_prompts

    tag = "[executors-serve-full]"
    t_phase = time.perf_counter()
    mods = kernel_modules()
    client, prv = broker.client, broker.colony_prv
    storage = MemoryStorage()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex = tx.ServeExecutor(client, COLONY, "h100-serve-full", "h100-serve", storage,
                          colony_prvkey=prv, arch="stablelm-3b", variant="full",
                          max_len=max(PROMPT_LENS) + NEW_TOKENS, device="cuda")
    torch.cuda.synchronize()
    engine, cfg = ex.engine, ex.engine.cfg
    n_params = count_params(model_spec(cfg))
    print(f"{tag} ServeExecutor stablelm-3b full: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} params in {cfg.param_dtype}, built in {time.perf_counter() - t0:.1f} s")
    check(n_params == 2_795_443_200 and cfg.num_layers == 32 and cfg.param_dtype == "float32",
          f"{n_params} params, {cfg.num_layers} layers, {cfg.param_dtype}")
    engine_s = []
    generate = engine.generate
    batch_started = threading.Event()

    def timed_generate(*args, **kwargs):  # the engine's own time per batch
        batch_started.set()
        t = time.perf_counter()
        out = generate(*args, **kwargs)  # ends in a copy to the host
        engine_s.append(time.perf_counter() - t)
        return out

    engine.generate = timed_generate
    try:
        ex.start(poll_timeout=0.2)
        g = client.add_generator({"colonyname": COLONY, "name": "serve-full", "queuesize": 4,
                                  "timeout": 60.0, "workflow": serve_workflow()}, prv)
        infc = InferenceClient(client, CFSClient(client, storage, prv), COLONY, g["generatorid"],
                               prv)
        requests = make_requests(PROMPT_LENS, cfg.vocab_size, NEW_TOKENS, seed=1)
        zero_launches(mods)
        t0 = time.perf_counter()
        rids = [infc.submit(r["prompt"], max_new_tokens=NEW_TOKENS) for r in requests[:4]]
        # The generator fires once 4 are queued, but drains all it holds: so
        # the next 4 go in once the first batch is on the engine, which this
        # process sees without asking the broker. The time held back is
        # reported, since the share outside the engine depends on it.
        t_wait = time.perf_counter()
        check(batch_started.wait(120), "the generator did not fire")
        wait_s = time.perf_counter() - t_wait
        rids += [infc.submit(r["prompt"], max_new_tokens=NEW_TOKENS) for r in requests[4:]]
        served = {rid: infc.wait(rid, timeout=600) for rid in rids}
        wall_s = time.perf_counter() - t0
        counts = {name: mod.launches for name, mod in mods.items()}
        check(broker.alive(), "the broker process died")
    finally:
        ex.stop()
        engine.generate = generate
    batches = [q for q in client.get_processes(COLONY, prv, state="successful", count=1000)
               if q["assignedexecutorid"] == ex.executorid]
    batches.sort(key=lambda q: q["submissiontime"])
    want = {name: 32 * len(batches) if name == "flash_attention" else 0 for name in mods}
    print(f"{tag} {len(requests)} requests in {len(batches)} batches of "
          f"{[len(q['spec']['kwargs']['packed_args']) for q in batches]}; engine stats "
          f"{engine.stats}; launches {counts} (want {want})")
    sizes = [len(q["spec"]["kwargs"]["packed_args"]) for q in batches]
    check(sizes == [4, 4] and engine.stats["batches"] == 2 and engine.stats["requests"] == 8,
          f"batches of {sizes}, engine stats {engine.stats}")
    check(counts == want, f"launches {counts}, want {want}")
    prefill_s = []
    for q in batches:
        packed = q["spec"]["kwargs"]["packed_args"]
        direct = engine.generate(pad_prompts(packed), max_new_tokens=NEW_TOKENS).tolist()
        got = [served[r["request_id"]] for r in packed]
        check(got == direct, "served tokens differ from the engine's own generate on the batch")
        tokens = torch.as_tensor(pad_prompts(packed), dtype=torch.long, device=engine.device)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(engine.params, cfg, {"tokens": tokens}, engine.max_len)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    n_tok = len(requests) * NEW_TOKENS
    engine_total = sum(engine_s)
    stats = {"wall_s": wall_s, "requests_per_s": len(requests) / wall_s,
             "tokens_per_s": n_tok / wall_s, "engine_s": engine_s, "prefill_s": prefill_s,
             "decode_s": [e - p for e, p in zip(engine_s, prefill_s)],
             "outside_engine_share": 1 - engine_total / wall_s, "held_back_s": wait_s,
             "outside_engine_share_less_held_back": 1 - engine_total / (wall_s - wait_s),
             "peak_bytes": peak}
    print(f"{tag} served tokens identical to generate on each batch; first: "
          f"{served[rids[0]]}")
    print(f"{tag} first submit to last result {wall_s:.3f} s: {len(requests) / wall_s:.3f} "
          f"requests/s, {n_tok / wall_s:.1f} tokens/s; engine per batch "
          f"{[round(x, 4) for x in engine_s]} s (prefill alone {[round(x, 4) for x in prefill_s]} "
          f"s, so decode {[round(x, 4) for x in stats['decode_s']]} s); outside the engine "
          f"(signed RPCs, CFS, generator wait) {stats['outside_engine_share']:.4f} of the wall "
          f"time, {stats['outside_engine_share_less_held_back']:.4f} without the "
          f"{wait_s:.3f} s that requests 5-8 were held back; max_memory_allocated {peak} bytes")
    del ex, engine
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} {stats['seconds']:.1f} s")
    return counts, stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    worst_err = phase_kernel_cases()
    worst_wkv = phase_wkv_cases()
    worst_mamba = phase_mamba_cases()
    grad_stats = phase_grad()
    stablelm_counts, stats = phase_slice("stablelm-3b", "full", PROMPT_LENS, {"flash_attention": 32})
    rwkv_counts, rwkv_stats = phase_slice("rwkv6-7b", "full", PRIME_PROMPT_LENS, {"rwkv6_wkv": 32})
    jamba_counts, jamba_stats = phase_slice("jamba-1.5-large-398b", "no-moe", PRIME_PROMPT_LENS,
                                            JAMBA_PER_PREFILL)
    phase_cross_device("granite-3-8b", "smoke", 72)
    phase_cross_device("rwkv6-7b", "smoke", 72, reseed_rwkv)
    phase_cross_device("jamba-1.5-large-398b", "smoke-no-moe", 67, reseed_jamba)
    train_counts, train_stats = phase_train_full(grad_stats)
    continuum_counts = phase_continuum_process()
    cross_worst = phase_train_cross()
    broker = Broker()
    try:
        broker_stats = phase_broker(broker)
        executor_counts, executor_stats = phase_executors_continuum(broker)
        serve_exec_counts, serve_exec_stats = phase_executors_serve_full(broker)
        check(broker.alive(), "the broker process died")
    finally:
        broker.close()
    foreign = reference_modules(sys.modules)
    print(f"[broker] stopped; modules of the reference or of JAX in this process: {foreign}")
    check(not foreign, f"this process imported {foreign}")
    paths = {"stablelm-3b": stablelm_counts, "rwkv6-7b": rwkv_counts,
             "jamba-1.5-large-398b": jamba_counts, "stablelm-3b train": train_counts,
             "stablelm-3b continuum": continuum_counts,
             "stablelm-3b executors-continuum": executor_counts,
             "stablelm-3b executors-serve-full": serve_exec_counts}
    launches = {name: sum(c[name] for c in paths.values()) for name in kernel_modules()}
    print(f"[done] launches per path {json.dumps(paths)}; summed {json.dumps(launches)}")
    flash_row, flash_serving = phase_timing(worst_err, launches["flash_attention"])
    kernels = [flash_row]
    wkv_row, prime = phase_wkv_timing(worst_wkv, launches["rwkv6_wkv"])
    mamba_row, serving = phase_mamba_timing(worst_mamba, launches["mamba_scan"])
    kernels += [wkv_row, mamba_row]
    print(f"[done] {time.perf_counter() - t0:.1f} s; serving stablelm-3b {json.dumps(stats)}; "
          f"flash attention at serving shapes {json.dumps(flash_serving)}")
    print(f"[done] serving rwkv6-7b {json.dumps(rwkv_stats)}; WKV at a prime prompt "
          f"{json.dumps(prime)}")
    print(f"[done] serving jamba-1.5-large-398b no-moe {json.dumps(jamba_stats)}; Mamba scan at "
          f"serving shapes {json.dumps(serving)}")
    print(f"[done] training stablelm-3b {json.dumps(train_stats)}; flash attention at the training "
          f"shape: forward {grad_stats['fwd_ms']:.4f} ms, backward {grad_stats['bwd_ms']:.4f} ms a "
          f"layer, its gradients within {grad_stats['worst_err']:.3e} of the plain twin's; train cuda "
          f"vs cpu {json.dumps(cross_worst)}")
    print(f"[done] broker {json.dumps(broker_stats)}; executors-continuum "
          f"{json.dumps(executor_stats)}; executors-serve-full {json.dumps(serve_exec_stats)}")
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--continuum"]:
        check(torch.cuda.is_available(), "no CUDA device")
        print(json.dumps(phase_continuum()))
        sys.exit(0)
    sys.exit(main())
