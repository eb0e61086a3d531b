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
  6. each kernel, its plain twin and, where there is one, a PyTorch call
     computing the same function, timed at a prefill shape and at the
     serving shapes beside the card's bound (the Mamba scan also beside
     the least time of its exponentials on the special-function unit).
The last line is the JSON result; the line before it lists the kernels,
and the one before that names the card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

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
    from repro_torch.launch.serve import MemorySink, build_engine, make_requests, serve
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
        sink = MemorySink()
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
        outs = [sink.tokens("serve", r["request_id"]) for r in requests]
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

    from repro_torch.launch.serve import MemorySink, serve
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
        serve(engine, requests, len(requests), MemorySink())
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
    stablelm_counts, stats = phase_slice("stablelm-3b", "full", PROMPT_LENS, {"flash_attention": 32})
    rwkv_counts, rwkv_stats = phase_slice("rwkv6-7b", "full", PRIME_PROMPT_LENS, {"rwkv6_wkv": 32})
    jamba_counts, jamba_stats = phase_slice("jamba-1.5-large-398b", "no-moe", PRIME_PROMPT_LENS,
                                            JAMBA_PER_PREFILL)
    phase_cross_device("granite-3-8b", "smoke", 72)
    phase_cross_device("rwkv6-7b", "smoke", 72, reseed_rwkv)
    phase_cross_device("jamba-1.5-large-398b", "smoke-no-moe", 67, reseed_jamba)
    paths = {"stablelm-3b": stablelm_counts, "rwkv6-7b": rwkv_counts,
             "jamba-1.5-large-398b": jamba_counts}
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
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
