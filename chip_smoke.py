#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. the card: name and power limit;
  2. the build: ``nvcc`` compiles the flash-attention kernel for sm_90a
     from the checkout's sources (registers, shared memory, spills);
  3. kernel against its plain-torch twin on the card, case by case;
  4. the slice: stablelm-3b at full width and depth in bf16 with seeded
     random weights answers 8 requests in batches of 4 through the batch
     handler; the kernel must launch once per layer per prefill, and
     greedy output must repeat exactly;
  5. granite (smoke, f32) on the card (kernel) against the CPU (plain
     twin) on the same weights: logits and greedy tokens;
  6. kernel, plain twin and PyTorch's fused attention timed at
     stablelm's prefill shape, beside the card's bound.
The last line is the JSON result; the line before it lists the kernels.
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


def phase_build() -> None:
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    kb = fa.build()
    print(f"[build] {' '.join(kb.command) if kb.command else 'reused ' + str(kb.path)}")
    for line in kb.log.splitlines():
        if line.strip():
            print(f"[build] {line.strip()}")
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


def phase_slice() -> tuple[int, dict]:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import MemorySink, build_engine, make_requests, serve
    from repro_torch.models import count_params, model_spec

    t0 = time.perf_counter()
    engine = build_engine("stablelm-3b", "full", max_len=max(PROMPT_LENS) + NEW_TOKENS, seed=0)
    cfg = engine.cfg
    torch.cuda.synchronize()
    print(f"[slice] stablelm-3b full: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{count_params(model_spec(cfg))} params in {cfg.param_dtype}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    requests = make_requests(PROMPT_LENS, cfg.vocab_size, NEW_TOKENS, seed=1)
    torch.cuda.reset_peak_memory_stats()

    runs = []
    for run in range(2):
        sink = MemorySink()
        batches_before = engine.stats["batches"]
        if run == 0:
            fa.launches = 0
        seconds = serve(engine, requests, 4, sink)
        if run == 0:
            launches = fa.launches
            prefills = engine.stats["batches"] - batches_before
            print(f"[slice] kernel launches {launches} over {prefills} prefills "
                  f"({cfg.num_layers} layers)")
            check(launches == cfg.num_layers * prefills,
                  f"kernel launched {launches} times, want {cfg.num_layers} per prefill")
        outs = [sink.tokens("serve", r["request_id"]) for r in requests]
        for o in outs:
            check(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o),
                  f"bad output {o}")
        n_tok = len(requests) * NEW_TOKENS
        print(f"[slice] run {run}: {len(requests)} requests, {n_tok} tokens, per batch "
              f"{[round(x, 4) for x in seconds]} s, {n_tok / sum(seconds):.1f} tokens/s")
        runs.append((outs, seconds))
    check(runs[0][0] == runs[1][0], "greedy output differs between two runs")
    peak = torch.cuda.max_memory_allocated()
    print(f"[slice] greedy output identical across runs; first request: {runs[0][0][0]}")
    print(f"[slice] max_memory_allocated {peak} bytes")
    stats = {"requests": len(requests), "tokens": len(requests) * NEW_TOKENS,
             "batch_s": runs[1][1], "tokens_per_s": len(requests) * NEW_TOKENS / sum(runs[1][1]),
             "peak_bytes": peak}
    stats.update(breakdown(engine, requests[:4]))
    del engine
    torch.cuda.empty_cache()
    return launches, stats


def breakdown(engine, requests: list[dict]) -> dict:
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
    print(f"[breakdown] B={tokens.shape[0]} S={tokens.shape[1]}: prefill {prefill_s:.4f} s, "
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
        print("[breakdown] profiler recorded no device time: busy share not measured")
        return {"prefill_s": prefill_s, "decode_step_s": decode_step_s}
    print(f"[breakdown] profiled batch: wall {wall_s:.4f} s, device busy {busy_s:.4f} s, "
          f"idle share {1 - busy_s / wall_s:.4f} (profiler overhead included)")
    for name, count, us in kernels[:8]:
        print(f"[breakdown]   {us / 1e3:10.3f} ms {count:6d}x {us / 1e6 / busy_s:7.2%} {name[:90]}")
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
    launches, stats = phase_slice()
    phase_cross_device()
    kernel = phase_timing(worst_err, launches)
    print(f"[done] {time.perf_counter() - t0:.1f} s; serving {json.dumps(stats)}")
    print(f"{card}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
