#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. the card: name and power limit;
  2. the build: ``nvcc`` compiles both kernels (flash attention, RWKV-6
     WKV) for sm_90a from the checkout's sources, in parallel, and prints
     their registers, shared memory and spills;
  3. each kernel against its plain-torch twin on the card, case by case;
  4. the slices: stablelm-3b and rwkv6-7b, each at full width and depth
     in bf16 with seeded random weights, answer 8 requests in batches of
     4 through the batch handler; with every launch count set to 0 just
     before, each slice's kernel must launch once per layer per prefill
     (and no other kernel at all), and greedy output must repeat exactly;
  5. granite and rwkv6 (smoke, f32) on the card (kernels) against the CPU
     (plain twins) on the same weights: logits and greedy tokens;
  6. each kernel, its plain twin and, where there is one, a PyTorch call
     computing the same function, timed at a prefill shape beside the
     card's bound.
The last line is the JSON result; the line before it lists the kernels,
and the one before that names the card.
"""

from __future__ import annotations

import json
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
]
PROMPT_LENS = [8, 300, 37, 129, 64, 200, 17, 150]  # batches of 4: S = 300, then 200
NEW_TOKENS = 16
TIMING_SHAPE = (4, 2048, 32, 80)  # B, S, H (= KV), D: stablelm prefill

# (B, T, H, K = V, chunk, nonzero s0, constant logw or None, label); f32,
# atol 1e-4 / rtol 1e-3 as in tests/test_kernels.py
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
]
WKV_ATOL, WKV_RTOL = 1e-4, 1e-3
# batches of 4 pad to T = 300 (WKV chunk 30), then T = 293 (prime: chunk 1)
RWKV_PROMPT_LENS = [8, 300, 37, 129, 64, 293, 17, 150]
WKV_TIMING_SHAPE = (4, 2048, 64, 64, 32)  # B, T, H, K = V, chunk: rwkv6-7b prefill
WKV_SERVING_SHAPE = (4, 293, 64, 64, 1)  # a prime-length prompt: chunk 1


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


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] nvidia-smi: {card}")
    print(f"[card] torch: {torch.cuda.get_device_name(0)}, devices: {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


def kernel_modules() -> dict:
    """Each kernel's module, by the name the kernels line gives it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6 as wkv

    return {"flash_attention": fa, "rwkv6_wkv": wkv}


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
    # bidirectional (causal=False) on a ragged S
    q, k, v = (torch.randn((1, 200, 4, 32), generator=gen, device="cuda") for _ in range(3))
    out = ops.flash_attention(q, k[:, :, :2], v[:, :, :2], causal=False)
    ref = plain_bshd(q, k[:, :, :2], v[:, :, :2], False, 0, 128)
    err = (out - ref).abs().max().item()
    print(f"[kernel] bidirectional S=200 f32 max_abs_err={err:.3e}")
    check(torch.allclose(out, ref, atol=2e-5, rtol=1e-4), "bidirectional case disagrees")
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
        out, s_final = wkv.rwkv6_cuda(*args, chunk=chunk)
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


def phase_slice(arch: str, prompt_lens: list[int], kernel: str) -> tuple[int, dict]:
    """Serve ``arch`` at full size; ``kernel`` must launch once per layer
    per prefill of the first run, and no other kernel at all."""
    from repro_torch.launch.serve import MemorySink, build_engine, make_requests, serve
    from repro_torch.models import count_params, model_spec

    tag = f"[slice {arch}]"
    mods = kernel_modules()
    t0 = time.perf_counter()
    engine = build_engine(arch, "full", max_len=max(prompt_lens) + NEW_TOKENS, seed=0)
    cfg = engine.cfg
    torch.cuda.synchronize()
    print(f"{tag} full: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads x {cfg.d_model // cfg.num_heads}, d_ff {cfg.d_ff}, "
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
            launches = counts[kernel]
            prefills = engine.stats["batches"] - batches_before
            print(f"{tag} kernel launches {counts} over {prefills} prefills "
                  f"({cfg.num_layers} layers)")
            check(launches == cfg.num_layers * prefills,
                  f"{kernel} launched {launches} times, want {cfg.num_layers} per prefill")
            check(all(n == 0 for name, n in counts.items() if name != kernel),
                  f"another kernel launched on the {arch} path: {counts}")
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
    return launches, stats


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
    for name, count, us in kernels[:8]:
        print(f"{tag}   {us / 1e3:10.3f} ms {count:6d}x {us / 1e6 / busy_s:7.2%} {name[:90]}")
    return {"prefill_s": prefill_s, "decode_step_s": decode_step_s,
            "profiled_wall_s": wall_s, "profiled_busy_s": busy_s}


def phase_cross_device() -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, model_spec
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("granite-3-8b", "smoke").copy(
        param_dtype="float32", compute_dtype="float32", use_pallas=True)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 72), generator=torch.Generator().manual_seed(1))
    on_cpu = ServeEngine(cfg, params, max_len=96, device="cpu")
    on_gpu = ServeEngine(cfg, params, max_len=96, device="cuda")
    with torch.inference_mode():
        lc, _ = forward(on_cpu.params, cfg, {"tokens": tokens})
        lg, _ = forward(on_gpu.params, cfg, {"tokens": tokens.cuda()})
    err = (lg.cpu() - lc).abs().max().item()
    ok = torch.allclose(lg.cpu(), lc, atol=5e-3, rtol=1e-3)
    print(f"[cross] granite smoke f32, S=72: logits cuda vs cpu max_abs_err={err:.3e} "
          f"(atol 5e-3, rtol 1e-3) {'ok' if ok else 'FAIL'}")
    check(ok, "granite logits differ between the card and the CPU")
    tc = on_cpu.generate(tokens.numpy(), max_new_tokens=NEW_TOKENS)
    tg = on_gpu.generate(tokens.numpy(), max_new_tokens=NEW_TOKENS)
    print(f"[cross] greedy tokens identical: {(tc == tg).all()}")
    check((tc == tg).all(), "greedy tokens differ between the card and the CPU")


def phase_cross_device_rwkv() -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, model_spec
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("rwkv6-7b", "smoke").copy(
        param_dtype="float32", compute_dtype="float32", use_pallas=True)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    # u, mu and mu_x init to zeros; seeded values exercise the bonus and the mixes
    gen = torch.Generator().manual_seed(4)
    mixer = params["groups"]["b0"]["mixer"]
    mixer["u"] = torch.randn(mixer["u"].shape, generator=gen) * 0.5
    for name in ("mu", "mu_x"):
        mixer[name] = torch.rand(mixer[name].shape, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 72), generator=torch.Generator().manual_seed(1))
    on_cpu = ServeEngine(cfg, params, max_len=96, device="cpu")
    on_gpu = ServeEngine(cfg, params, max_len=96, device="cuda")
    with torch.inference_mode():
        lc, _ = forward(on_cpu.params, cfg, {"tokens": tokens})
        lg, _ = forward(on_gpu.params, cfg, {"tokens": tokens.cuda()})
    err = (lg.cpu() - lc).abs().max().item()
    ok = torch.allclose(lg.cpu(), lc, atol=5e-3, rtol=1e-3)
    print(f"[cross] rwkv6 smoke f32, T=72 (chunk 24): logits cuda vs cpu max_abs_err={err:.3e} "
          f"(atol 5e-3, rtol 1e-3) {'ok' if ok else 'FAIL'}")
    check(ok, "rwkv6 logits differ between the card and the CPU")
    tc = on_cpu.generate(tokens.numpy(), max_new_tokens=NEW_TOKENS)
    tg = on_gpu.generate(tokens.numpy(), max_new_tokens=NEW_TOKENS)
    print(f"[cross] rwkv6 greedy tokens identical: {(tc == tg).all()}")
    check((tc == tg).all(), "rwkv6 greedy tokens differ between the card and the CPU")


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
        out, s_final = wkv.rwkv6_cuda(*args, chunk=chunk)
        ref_out, ref_s = wkv.rwkv6_plain(*args, chunk=chunk)
        err = max((out - ref_out).abs().max().item(), (s_final - ref_s).abs().max().item())
        check(torch.allclose(out, ref_out, atol=WKV_ATOL, rtol=WKV_RTOL)
              and torch.allclose(s_final, ref_s, atol=WKV_ATOL, rtol=WKV_RTOL),
              f"WKV timing shape {label} disagrees: {err}")
        kernel_ms = cuda_ms(lambda: wkv.rwkv6_cuda(*args, chunk=chunk), 3, 20)
        plain_ms = cuda_ms(lambda: wkv.rwkv6_plain(*args, chunk=chunk), 1, 3)
        t_ops, ops, t_bytes, nbytes = wkv_bound(b * h, t, k, k, chunk)
        print(f"[time] WKV {label}: B={b} T={t} H={h} K=V={k} chunk={chunk} f32: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, no library call; bound "
              f"{max(t_ops, t_bytes):.4f} ms ({ops} ops -> {t_ops:.4f} ms, {nbytes} bytes -> "
              f"{t_bytes:.4f} ms); max_abs_err {err:.3e}")
        rows[label] = {"shape": [b, t, h, k, chunk], "ms": kernel_ms, "plain_ms": plain_ms,
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


def phase_timing(worst_err: float, launches: int) -> dict:
    from repro_torch.kernels import flash_attention as fa

    b, s, h, d = TIMING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((b * h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = fa.flash_attention_cuda(q, k, v, group=1, causal=True)
    ref = fa.flash_attention_plain(q, k, v, group=1, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.allclose(out.float(), ref.float(), atol=3e-2, rtol=3e-2),
          f"timing shape disagrees: {err}")
    kernel_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, group=1, causal=True), 3, 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, group=1, causal=True), 1, 5)
    q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 3, 20)
    flops = 4 * b * h * d * s * (s + 1) / 2  # q.k and p.v over the causal pairs
    nbytes = 4 * b * s * h * d * 2  # q, k, v read once and o written once, bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    print(f"[time] B={b} S={s} H={h} D={d} bf16 causal: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; bound {max(t_ops, t_bytes):.4f} ms "
          f"({flops:.4g} ops -> {t_ops:.4f} ms, {nbytes} bytes -> {t_bytes:.4f} ms); "
          f"max_abs_err {err:.3e}")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": launches,
        "max_abs_err": max(worst_err, err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    worst_err = phase_kernel_cases()
    worst_wkv = phase_wkv_cases()
    launches, stats = phase_slice("stablelm-3b", PROMPT_LENS, "flash_attention")
    wkv_launches, rwkv_stats = phase_slice("rwkv6-7b", RWKV_PROMPT_LENS, "rwkv6_wkv")
    phase_cross_device()
    phase_cross_device_rwkv()
    kernels = [phase_timing(worst_err, launches)]
    wkv_row, prime = phase_wkv_timing(worst_wkv, wkv_launches)
    kernels.append(wkv_row)
    print(f"[done] {time.perf_counter() - t0:.1f} s; serving stablelm-3b {json.dumps(stats)}")
    print(f"[done] serving rwkv6-7b {json.dumps(rwkv_stats)}; WKV at a prime prompt "
          f"{json.dumps(prime)}")
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
