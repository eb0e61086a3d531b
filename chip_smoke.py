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
     in bfloat16; flash attention also bidirectional and with k/v of a
     length of their own, at llama-vision's and seamless's cross-attention
     and seamless's encoder); where a case's window is shorter than its
     sequence, the twin without the window and with a shorter one must
     fail the case's bar, and past a thousand keys the twin without the
     last 64;
  4. the slices: stablelm-3b and rwkv6-7b at full width and depth,
     jamba-1.5-large without experts at full width and 16 layers,
     mixtral-8x7b at every published width and 16 of 32 layers
     (``half-depth``), and deepseek-v3-671b at every published width with
     its 3 dense-prefix and 2 of its 58 MoE layers (``two-moe``), each in
     bf16 with seeded random weights, answer 8
     requests in batches of 4 through the batch handler; with every launch
     count set to 0 just before, each kernel must launch exactly as often
     per prefill as the slice's layout says (and a kernel it does not name,
     never), and greedy output must repeat exactly. Each slice's breakdown
     takes a batch of 4 two ways: a prefill and an eager ``decode_step``
     loop, and the same batch through the engine, which decodes by
     replaying the one CUDA graph it captured for the batch's decode key;
     the greedy tokens must be equal for all ``NEW_TOKENS``, the first
     step's logits within ``CAPTURED_LOGITS_BAR`` (the largest difference
     printed), and every key must hold one graph; decode ms a step and
     the peak are printed for both, and a profiled batch's idle share for
     the engine's. For mixtral and
     deepseek the served tokens must also equal direct ``generate``, B1
     must launch once per attention layer in a prefill and never in a
     decode step, and the share of dropped (token, choice) pairs is printed
     for a prefill (also split between the left padding and the prompts'
     own tokens) and a decode step; ``[mixtral-swa]`` holds 16 decode steps
     past the 4,096-token window (B=1, prompt 4,352) to the forward at the
     bf16 bar, with B1 launched once per layer in the forward and in the
     prefill, while the forward without the window must fall outside that
     bar. For deepseek the decode cache's bytes per token and layer are
     held to MLA's 576 values, and ``[mla-absorb]`` holds 16 absorbed
     decode steps of one full-width MLA layer (B=4, a 300-token prefill)
     to the expanded ``mla_fwd`` at ``MLA_ABSORB_ATOL``/``RTOL``, while the
     forward one position off must fall outside that bar. Then
     llama-3.2-vision-11b and seamless-m4t-large-v2 at full width and
     depth, every cross-attention gate set to ``GATE`` (0 at init, where
     the memory reaches nothing), each request with a seeded memory of
     its own (1,601 image patches; 1,000 source frames), served through
     ``generate(..., extras=...)`` since the batch handler passes no
     memory (ROADMAP C19): B1 40 and 72 a prefill (causal,
     cross-attention, and seamless's bidirectional encoder), and
     ``[xattn-decode]``: B=1, a 300-token prompt, 16 decode steps held to
     the forward (a float32 copy of the weights at ``XATTN_DECODE_ATOL``,
     the bf16 distances printed), while the forward on another request's
     memory must fall outside that bar. On stablelm-3b's weights,
     ``[dryrun]``: a prefill of 4 x 2,048 and one decode step at position
     2,048 (a cache of 2,064), each traced by the dry-run
     (``launch.dryrun_lib.run_cell``) on a (1, 1) mesh of fake CUDA
     tensors, then run for real through ``make_prefill`` and
     ``make_serve_step``: ``FlopCounterMode``'s FLOPs equal to the trace's,
     the predicted peak within ``DRYRUN_PEAK_RTOL`` of the measured, B1
     32 times in the prefill through ``repro_torch::flash_attention`` and
     never in the decode step, greedy tokens at a position tensor equal to
     the served ones, and each cell's measured roofline fraction;
  5. granite, rwkv6, jamba (with and without experts), mixtral, starcoder2,
     qwen2.5, deepseek, llama-vision and seamless (smoke, f32) on the card
     (kernels) against the CPU (plain twins) on the same weights (and
     memory): logits, greedy tokens and exact launch counts;
  6. ``[grad]``: flash attention under grad (the custom op's gradient,
     which recomputes through the twin): one kernel launch per forward,
     the kernel's own output, and dq/dk/dv against autograd through the
     plain twin on the card; the same for the WKV and scan ops under grad
     (``ops.rwkv6_chunked``, ``ops.mamba_chunk_scan`` at the model's
     layout, as the models call them), at their f32 bar and at the decay
     clip's top (w0 = 4); the attention
     backward's recomputation timed at stablelm's training shape;
  7. ``[train-full]``: stablelm-3b at full width and depth (bf16, remat
     "full", AdamW, B=4, S=1024, 2 microbatches) takes 3 steps of
     ``make_train_step``: finite losses and grad norms, a first CE near
     ln V, every parameter leaf changed, and exactly 128 flash attention
     launches a step (32 layers, forward and recomputation, per
     microbatch); step time, tokens/s, peak memory, a profiled step's
     device busy time and idle share, and a breakdown (forward, backward,
     the recomputation through the twin, the optimizer update); then
     ``[dryrun]``'s train cell: the trace of this step against its
     measured time and peak;
  8. ``[train-graph]``: ``[train-full]``'s configuration and data, eager
     (``make_train_step``) and then captured (``TrainStep``: the first
     step eager, the next captured in a CUDA graph and replayed, the rest
     replays), each from the seed-0 state (rebuilt between the runs: two
     do not fit the card) under deterministic algorithms, in a process of
     its own (``chip_smoke.py --train-graph``, ``CONTINUUM_ENV``), 7
     steps each: losses, grad norms and every parameter bit-identical, 128
     flash attention launches on every step, replays included; s a step
     and tokens/s for both, peaks (allocated and reserved; the capture's,
     the graph's pool), the capture's seconds, and a profiled replay's
     idle share beside ``[train-full]``'s profiled eager step's; then 4
     eval batches at that width through ``EvalStep``, bit-identical to the
     eager ``make_eval_step``;
  9. ``[continuum]``: the reference's main path on the card at smoke size
     in float32 through ``runtime.train_loop`` (its train and eval steps
     captured, ``TrainStep`` and ``EvalStep``): ``prepare_data``, ``train``
     crashing at step 3 and resuming from ``latest.json``, ``evaluate``, and
     a ``ServeEngine`` on the restored parameters behind the batch handler;
     straight and resumed runs agree at atol 1e-6 (deterministic
     algorithms, in a process of its own with a fixed cuBLAS workspace),
     and greedy tokens equal those of the in-memory params;
 10. ``[train-cross]``: three smoke f32 steps on the card (``TrainStep``: a
     warm-up, a capture, a replay) against the CPU's eager body on the
     same parameters and batches, 1 and 2 microbatches, for stablelm
     (AdamW and Adafactor), mixtral, rwkv6, jamba with experts, deepseek
     (MLA, the dense prefix and MTP, with ``mtp_ce``) and seamless (AdamW),
     and llama-vision (Adafactor):
     loss, grad norm and parameters at each case's bar in
     ``TRAIN_CROSS_CASES``, and exact launch counts on the card;
 11. ``[broker]``: the port's copy of the broker (``repro_torch.broker``)
     over its indexed ``MemoryDatabase``, in a process of its own
     (``BROKER_SOURCE``: signatures verified, no torch, no jax, no module
     of ``repro``), reached
     only over HTTP through the port's signed client; the colony, and the
     mean round trip of 20 signed ``colonystats``;
 12. ``[executors-continuum]``: both DAGs of the reference's continuum test
     on the port's executors on the card (smoke, f32): train, restore from
     CFS and serve through a generator; then prepare_data -> train (two
     trainers crash at step 3, the failsafe re-queues at a lease of 3x the
     measured attempt, the resume) -> evaluate, with flash attention's
     launches counted for the steps and batches that ran;
 13. ``[executors-serve-full]``: a ServeExecutor of full-width stablelm-3b
     (float32) behind a generator of queuesize 4: 8 signed requests over
     HTTP in 2 batches, 32 flash attention launches a prefill, tokens equal
     to the engine's own generate, the first batch's also to an eager
     ``decode_step`` loop, one graph for the key; wall time, requests/s,
     tokens/s, the
     engine's seconds per batch and the share outside it (requests 5-8
     wait until batch 1 is on the engine; that wait is reported); this process
     then holds no module of ``repro`` or JAX;
 14. ``[durable-broker]``, ``[durable-continuum]``, ``[durable-serve-full]``:
     the broker process over a ``SqliteDatabase`` file of 10,000
     processes written through the port's ``SqliteDatabase`` (9,000
     closed, 1,000 waiting for no executor), each phase SIGKILLing it and
     starting it again on the same port over the file: signed
     ``colonystats`` with the counts written, before and after a restart,
     beside ``[broker]``'s round trip; ``[executors-continuum]``'s hand-off
     with a kill while ``train`` runs (it closes successful once, 0
     retries, its lease kept in the file) and one between the 2nd and 3rd
     pack of the serving generator (it fires once, with 4; tokens equal
     to ``generate``; B1 as the hand-off's); ``[executors-serve-full]``
     with a kill between its two batches (tokens equal, B1 64); each
     restart's seconds from the kill to the new process's port;
 15. ``[ha-broker]``, ``[ha-continuum]``, ``[ha-serve-full]``: the port's
     replicated broker (``HA_BROKER_SOURCE``: three replicas behind Raft,
     one HTTP server each, the digest check armed, no torch, no jax, no
     module of ``repro``) and the mean signed round trip a replica; DAG 1
     of the continuum behind it (CFS on a ``ShardedStorage`` of 3 shards,
     R = 2, one shard dead once the data is in; the leader replica killed
     at the first trainer crash; every process successful, a new leader,
     no attempt held by two executors, no divergence, evaluate's output
     equal to ``[executors-continuum]``'s within 1e-6, the scrub restoring
     2 replicas of every key, launches counted); then
     ``[executors-serve-full]`` behind it, the leader killed between the two
     batches while a ``ChaosMonkey`` kills and respawns CPU workers that
     drain ``HA_BACKLOG`` echo processes (tokens equal to generate, 32
     flash attention launches a prefill, each process ended once; the
     failover's seconds and each batch beside ``[executors-serve-full]``'s);
     every broker process of phases 11-15 runs under the port's runtime
     detectors (``DETECTOR_ENV``: the lock-order detector and the auth-fact
     contracts), and its report is read at the end of each phase and
     before each SIGKILL: both detectors on, no lock-order violation, no
     contract error, and the lock families the process must use held;
 16. ``[contracts]``: the port's six static gates (``python -m
     repro_torch.analysis.{lint,authlint,replint,idemlint}`` and
     ``{authmap,replmap} --check`` against ``TORCH_CONTRACTS.md``), each
     exiting 0, and every broker process's report, phase by phase;
 17. ``[launch]``: the launchers' own CLIs through the broker and the
     executors: ``launch.serve`` of full-width stablelm-3b (float32) in
     this process, 8 requests in 2 waves of 4: 2 batches of 4, 32 flash
     attention launches a prefill and none of the scans, tokens equal to
     the engine's own generate on each batch the broker formed (the first
     batch's also to an eager ``decode_step`` loop, one graph for the
     key), and each
     served prefill's cache equal to ``abstract_cache`` in paths, shapes
     and dtypes; wall time, tokens/s and the share outside the engine.
     Then ``launch.train`` at smoke size (6 steps) in a process of its own
     under deterministic algorithms: both JSON outputs, within
     ``LAUNCH_ATOL`` of the training handlers called directly, and exact
     launch counts; and ``launch.train`` of full-width stablelm-3b
     (float32, AdamW, 2 steps, its whole state checkpointed through CFS and
     restored by ``evaluate``), held the same way to the direct handlers,
     each run in a child process of its own;
 18. each kernel, its plain twin and, where there is one, a PyTorch call
     computing the same function, timed at a prefill shape and at the
     serving shapes beside the card's bound (flash attention also at
     mixtral's window of 4,096 over 4,352 tokens, at MLA's prefill,
     head dim 192 with V padded from 128, and at llama-vision's and
     seamless's cross-attention and seamless's encoder, bidirectional;
     the Mamba scan also
     beside the least time of its exponentials on the special-function
     unit).
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
from repro_torch import trace  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3

# The bf16 bar at mixtral's shapes: a row there averages hundreds to
# thousands of keys, so outputs are about 0.03 and an absolute 3e-2 would
# pass a kernel that ignores the window. 4e-3 absolute with two bf16 steps
# relative (1.6e-2) holds them; phase_kernel_cases shows that a twin
# without the window, or with one 128-key tile less, fails it.
MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL = 4e-3, 1.6e-2
# MLA at full width (deepseek-v3): q and k of head dim qk_nope + qk_rope =
# 128 + 64, V padded from 128 to that dim, 128 heads, MHA. At S = 200-300 a
# row averages up to 300 keys, so outputs fall to about 0.06 and B1 is held
# there at the tighter bar of mixtral's shapes.
MLA_HEAD_DIM, MLA_V_DIM, MLA_HEADS = 192, 128, 128
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
    # the smoke configs [cross-device] and [train-cross] run in float32
    (2, 72, 4, 2, 16, 8, 16, torch.float32, 2e-5, 1e-4, "mixtral smoke window 8 f32"),
    (2, 72, 6, 2, 16, 0, 16, torch.float32, 2e-5, 1e-4, "starcoder2 smoke GQA group 3 f32"),
    (2, 72, 5, 1, 16, 0, 16, torch.float32, 2e-5, 1e-4, "qwen2.5 smoke GQA group 5, D=16 f32"),
    # mixtral half-depth: serving, and the window at full width
    (4, 300, 32, 8, 128, 4096, 128, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "mixtral serving S=300"),
    (1, 4352, 32, 8, 128, 4096, 128, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "mixtral window 4096, S=4352"),
    # deepseek-v3 two-moe: MLA's serving shapes at D = 192, a ragged S, the
    # f32 scalar kernel at D = 192, and the smoke config's D = 24
    (4, 300, 128, 128, 192, 0, 128, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "MLA serving S=300, D=192"),
    (4, 200, 128, 128, 192, 0, 128, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "MLA serving S=200, D=192"),
    (1, 77, 128, 128, 192, 0, 128, torch.bfloat16, 3e-2, 3e-2, "MLA D=192 ragged S=77"),
    (2, 160, 128, 128, 192, 0, 128, torch.float32, 2e-5, 1e-4, "MLA D=192 f32, S=160"),
    (2, 72, 4, 4, 24, 0, 16, torch.float32, 2e-5, 1e-4, "deepseek smoke D=24 f32"),
    (2, 72, 4, 4, 24, 0, 16, torch.bfloat16, 3e-2, 3e-2, "deepseek smoke D=24 bf16"),
]
# B1 with k/v of a length of their own (cross-attention), and bidirectional
# at seamless's encoder shape: (B, S_q, S_kv, H, KV, D, dtype, atol, rtol,
# label). llama-3.2-vision cross-attends from the text to 1,601 image
# patches (GQA group 4, D = 128), seamless from the text to its encoder's
# 1,000 frames (group 1, D = 64): both ragged against the 64-row tile, S_q
# below and above S_kv. Rows of a thousand keys and more average their
# values down to about 0.03, so bf16 is held there at mixtral's bar, and the
# twin without the last 64 keys must fail it.
XATTN_CASES = [
    (4, 300, 1601, 32, 8, 128, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "llama-vision cross S_q=300, S_kv=1601"),
    (4, 200, 1601, 32, 8, 128, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "llama-vision cross S_q=200, S_kv=1601"),
    (1, 2048, 1601, 32, 8, 128, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "S_q=2048 > S_kv=1601, group 4"),
    (4, 300, 1000, 16, 16, 64, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "seamless cross S_q=300, S_kv=1000"),
    (2, 1601, 1000, 16, 16, 64, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "S_q=1601 > S_kv=1000, group 1"),
    (4, 1000, 1000, 16, 16, 64, torch.bfloat16, MIXTRAL_BF16_ATOL, MIXTRAL_BF16_RTOL,
     "seamless encoder S=1000, bidirectional"),
    (2, 1000, 300, 16, 16, 64, torch.bfloat16, 3e-2, 3e-2, "S_q=1000 > S_kv=300, group 1"),
    (2, 300, 1601, 32, 8, 128, torch.float32, 2e-5, 1e-4, "llama-vision cross f32"),
    (2, 300, 1000, 16, 16, 64, torch.float32, 2e-5, 1e-4, "seamless cross f32"),
    (1, 1601, 1000, 8, 2, 64, torch.float32, 2e-5, 1e-4, "S_q=1601 > S_kv=1000 f32, group 4"),
    # the smoke configs of [cross] (T = 72; 17 patches, 40 frames) and
    # [train-cross] (T = 64; 17 patches, 64 frames), f32, D = 16
    (2, 72, 17, 4, 2, 16, torch.float32, 2e-5, 1e-4, "llama-vision smoke cross f32"),
    (2, 72, 40, 4, 4, 16, torch.float32, 2e-5, 1e-4, "seamless smoke cross f32"),
    (2, 40, 40, 4, 4, 16, torch.float32, 2e-5, 1e-4, "seamless smoke encoder f32"),
    (4, 64, 17, 4, 2, 16, torch.float32, 2e-5, 1e-4, "llama-vision smoke train cross f32"),
]
# (S, D, dtype, atol, rtol): bidirectional, ragged S, GQA group 2
BIDIR_CASES = [
    (200, 32, torch.float32, 2e-5, 1e-4),
    (300, 80, torch.bfloat16, 3e-2, 3e-2),
    (200, 128, torch.bfloat16, 3e-2, 3e-2),
]
PROMPT_LENS = [8, 300, 37, 129, 64, 200, 17, 150]  # batches of 4: S = 300, then 200
NEW_TOKENS = 16
# A captured decode step runs eager's kernels, so its logits should be
# eager's bit for bit; should cuBLAS pick another algorithm under capture,
# they are held at the bf16 bar instead.
CAPTURED_LOGITS_BAR = 3e-2
TIMING_SHAPE = (4, 2048, 32, 32, 80)  # B, S, H, KV, D: stablelm prefill
FLASH_SERVING_SHAPES = {"stablelm S=300": (4, 300, 32, 32, 80), "jamba S=300": (4, 300, 64, 8, 128)}
# [mixtral-swa]: B, S, H, KV, D and the window at which the window bites
SWA_SHAPE, SWA_WINDOW = (1, 4352, 32, 8, 128), 4096

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
# [grad] for the WKV and scan kernels: (label, B, T, H or DI, K or N, chunk,
# then a constant logw or None for WKV, x's dtype for the scan); w0 = 4 is
# the decay clip's top, where the reference's gradient is NaN (ROADMAP
# C13). The first case of each is a layer of [train-cross]'s smoke step,
# where the backward is also timed.
WKV_GRAD_CASES = [("rwkv6 smoke train step", 4, 64, 4, 16, 32, None),
                  ("rwkv6-7b heads, T=64", 1, 64, 64, 64, 32, None),
                  ("w0 = 4 (C13)", 2, 64, 4, 16, 32, -math.exp(4.0))]
MAMBA_GRAD_CASES = [("jamba smoke train step", 4, 64, 128, 4, 64, torch.float32),
                    ("jamba smoke width, T=67", 2, 67, 128, 4, 1, torch.float32),
                    ("N=16, T=120", 2, 120, 512, 16, 60, torch.float32),
                    ("bf16 x, N=16, T=120", 2, 120, 512, 16, 60, torch.bfloat16)]
# [train-full]: stablelm-3b, B=4, S=1024, 2 microbatches, 3 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 1024, 2, 3
# [dryrun]: stablelm-3b full in bf16, three cells one card holds, each
# traced on a (1, 1) mesh of fake CUDA tensors and run for real; (name,
# seq_len, batch, kind): a prefill of 4 x 2,048; one decode step of 4 at
# position 2,048 against a cache of 2,064; [train-full]'s own step
DRYRUN_CELLS = [("dryrun_prefill", 2048, 4, "prefill"), ("dryrun_decode", 2064, 4, "decode"),
                ("dryrun_train", TRAIN_SEQ, TRAIN_BATCH, "train")]
DRYRUN_DECODE_POS = 2048
DRYRUN_PEAK_RTOL = 0.20  # predicted peak (arguments + temporaries) against the measured
# the autograd node of B1's custom op (torch names it after the op)
B1_BACKWARD_NODE = "repro_torch_flash_attention"
# [train-graph]: [train-full]'s step, eager and captured, each for this many
# timed steps and one profiled, then this many eval batches at that width
TRAIN_GRAPH_STEPS, TRAIN_GRAPH_EVALS = 6, 4
# [continuum]: the reference handlers' smoke run, cut to 6 steps of 4 x 64.
# It turns deterministic algorithms on, and cuBLAS is deterministic only
# with a fixed workspace, set before CUDA starts: so it runs in a process
# of its own with this environment, and every other phase runs with the
# default workspace.
CONTINUUM_KW = dict(arch="stablelm-3b", steps=6, batch=4, seq_len=64, checkpoint_every=2)
CONTINUUM_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# [launch]: the launchers' own CLIs, through the broker and the executors.
# Serving answers 8 requests in 2 waves of 4 at full width (float32, as the
# executor builds it), prompts of up to the launcher's 300 tokens; training
# is the continuum's smoke run, 6 steps, through the TrainerExecutor, in a
# process of its own under CONTINUUM_ENV, so it can be held at 1e-6 to the
# handlers called directly
LAUNCH_SERVE_ARGS = ["--arch", "stablelm-3b", "--variant", "full", "--device", "cuda",
                     "--requests", "8", "--batch-size", "4", "--max-new-tokens", "16"]
LAUNCH_TRAIN_ARGS = ["--arch", "stablelm-3b", "--variant", "smoke", "--steps", "6",
                     "--checkpoint-every", "2", "--device", "cuda"]
LAUNCH_TRAIN_KW = dict(arch="stablelm-3b", variant="smoke", steps=6, batch=4, seq_len=64,
                       microbatches=1, optimizer="adamw", learning_rate=3e-4,
                       checkpoint_every=2, run="cli-run", use_pallas=False)
# and full-width stablelm-3b (float32, 11.2 GB of weights and 22.4 GB of AdamW
# moments) for 2 steps, one checkpoint of its 33.5 GB state through signed
# CFS, and the evaluate that restores it
LAUNCH_TRAIN_FULL_ARGS = ["--arch", "stablelm-3b", "--variant", "full", "--steps", "2",
                          "--checkpoint-every", "2", "--device", "cuda"]
LAUNCH_TRAIN_FULL_KW = dict(LAUNCH_TRAIN_KW, variant="full", steps=2)
LAUNCH_ATOL = 1e-6
# [train-cross]: cuda against cpu after 3 smoke f32 steps; the largest
# differences measured on an H100 were 1.9e-6 (grad norm) and 3.2e-7 (params)
TRAIN_CROSS_ATOL, TRAIN_CROSS_RTOL = 1e-5, 1e-5
# (arch, variant, optimizers, (atol, rtol), reseed name): stablelm,
# mixtral and deepseek run only B1 and plain torch, at the stablelm bar; rwkv6 (B2) and
# jamba with experts (B3, B1) at the WKV and scan kernels' f32 bar
TRAIN_CROSS_CASES = [
    ("stablelm-3b", "smoke", ("adamw", "adafactor"), (TRAIN_CROSS_ATOL, TRAIN_CROSS_RTOL), None),
    ("mixtral-8x7b", "smoke", ("adamw",), (TRAIN_CROSS_ATOL, TRAIN_CROSS_RTOL), None),
    ("rwkv6-7b", "smoke", ("adamw",), (WKV_ATOL, WKV_RTOL), "rwkv"),
    ("jamba-1.5-large-398b", "smoke", ("adamw",), (MAMBA_ATOL, MAMBA_RTOL), "jamba"),
    ("deepseek-v3-671b", "smoke", ("adamw",), (TRAIN_CROSS_ATOL, TRAIN_CROSS_RTOL), None),
    # gates at GATE; llama-vision under Adafactor, whose factored second
    # moment does not blow a near-zero gradient's rounding up to a step of
    # lr as AdamW's elementwise m / sqrt(v) can (tests/test_torch_encdec_model.py)
    ("llama-3.2-vision-11b", "smoke", ("adafactor",), (TRAIN_CROSS_ATOL, TRAIN_CROSS_RTOL),
     "gates"),
    ("seamless-m4t-large-v2", "smoke", ("adamw",), (TRAIN_CROSS_ATOL, TRAIN_CROSS_RTOL), "gates"),
]
# mixtral half-depth: 16 layers of [attention (window 4096) + 8 experts]
MIXTRAL_PER_PREFILL = {"flash_attention": 16}
MIXTRAL_PARAMS = 23_482_470_400
# deepseek-v3 two-moe: 3 dense-prefix and 2 MoE layers, each MLA (B1 at
# D = 192); the MTP block runs only in training
DEEPSEEK_PER_PREFILL = {"flash_attention": 5}
DEEPSEEK_PARAMS = 26_952_316_928
# [mla-absorb]: one MLA layer of two-moe, B=4, a 300-token prefill, 16
# absorbed decode steps held to the expanded forward. Past 300 keys the
# outputs are at most 0.011 (on an H100): an atol of 1e-3, set from a layer at
# S=96 on the CPU (outputs up to 0.37), let the forward one position off
# (6.7e-4 to 8.5e-4 away) pass, so the bar is 1e-4 with two bf16 steps
# relative; the absorbed decode was 6.1e-5 (one bf16 step) away.
MLA_ABSORB_ATOL, MLA_ABSORB_RTOL = 1e-4, 1e-2
MLA_ABSORB_BATCH, MLA_ABSORB_PROMPT = 4, 300
# The cross-attending configs. Every tanh gate starts at 0, where the memory
# reaches nothing; every phase sets it to GATE in the weights it runs.
GATE = 1.0
SERVE_MEMORY_LEN = 1000  # seamless: source frames a request (max_src_len 4096)
# B1's timing rows at the new serving shapes: (label, (B, S_q, H, KV, D), S_kv)
XATTN_TIMING_SHAPES = [
    ("llama-vision cross S_q=300, S_kv=1601", (4, 300, 32, 8, 128), 1601),
    ("seamless encoder S=1000, bidirectional", (4, 1000, 16, 16, 64), 1000),
    ("seamless cross S_q=300, S_kv=1000", (4, 300, 16, 16, 64), 1000),
]
# llama-3.2-vision full: 8 groups of [cross-attention + 4 x attention], so
# B1 32 causal + 8 cross (S_kv = 1,601 patches) a prefill
VISION_PER_PREFILL = {"flash_attention": 40}
VISION_PARAMS = 9_729_019_912
# seamless-m4t-large-v2 full: 24 bidirectional encoder layers, then 24 decoder
# layers of [self-attention + cross-attention]: B1 72 a prefill
SEAMLESS_PER_PREFILL = {"flash_attention": 72}
SEAMLESS_PARAMS = 1_633_304_600
# [xattn-decode]: B=1, a 300-token prompt with its memory, 16 decode steps
# held to the forward, with the forward on another request's memory as the
# control. In bf16 they round apart: decode's cross- and self-attention take
# bf16 scores in plain torch (as the reference decodes), the forward B1's
# float32 scores. On an H100, 16 steps were 6.2e-2 to 1.0e-1 (rms 1.4e-2 to
# 2.0e-2) from the forward, while seamless's control was only 0.20 to 0.24
# off (rms 4.5e-2); a float32 copy of the same weights was within 1.8e-5
# (llama-vision) and 1.1e-5 (seamless), its control 0.17 to 1.8 off. So the
# bar holds the float32 copy, atol 1e-4, rtol 1e-4, and the bf16 distances
# are printed beside it.
XATTN_DECODE_PROMPT = 300
XATTN_DECODE_ATOL, XATTN_DECODE_RTOL = 1e-4, 1e-4


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def plain_bshd(q, k, v, causal, window, block_k):
    """The plain twin on the model-facing layout, as ops.flash_attention
    reshapes for the kernel (k and v may have a length of their own)."""
    from repro_torch.kernels import flash_attention as fa

    b, s, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    out = fa.flash_attention_plain(
        q.transpose(1, 2).reshape(b * h, s, d), k.transpose(1, 2).reshape(b * kv, s_kv, d),
        v.transpose(1, 2).reshape(b * kv, s_kv, d), group=h // kv, causal=causal,
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


def device_ms(fn, iters: int, repeats: bool = False) -> float:
    """Mean device time per call: for each kernel ``fn`` launches, its
    device time under the profiler over the launches the profiler recorded
    of it (at most ``iters``), summed over the kernels. Unlike ``cuda_ms``
    it leaves out any gap between launches. With ``repeats`` (a library
    call, which may launch one kernel more than once) a kernel may launch
    more often than ``iters``, and its time per launch counts as many times
    a call as it launched (its count over ``iters``, rounded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # The profiler now and then records nothing, or loses launches and then
    # often part of the time of those it kept (the Mamba scan at T=293 with
    # bf16 x: five attempts of ``timed``, each beside a profile that had
    # lost launches, read 0.056-0.142 ms a call against events of 0.119):
    # ask again, and keep a partial profile only from the third try on.
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = max((e.count for e in events), default=0)
        if calls >= iters or (calls and attempt >= 2):
            break
    check(0 < calls and (repeats or calls <= iters),
          f"the profiler recorded {calls} launches of {iters} calls")
    if calls < iters:
        print(f"[time] the profiler recorded {calls} of {iters} calls")
    return sum(e.self_device_time_total / e.count * (max(1, round(e.count / iters)) if repeats else 1)
               for e in events if e.count) / 1e3


def timed(fn, warmup: int, iters: int, dev_iters: int, bound_ms: float,
          what: str, repeats: bool = False) -> tuple[float, float]:
    """(``cuda_ms``, ``device_ms``) of ``fn``. The device time is the mean
    of two profiles, and all is measured again (at most five times) until
    the two agree within 5% and both lie between the bound and the events
    time (with 5% for noise): a profile that kept a launch's count but lost
    part of its time reads below what the card did, and one that kept stray
    time reads above the events' wall time."""
    for _ in range(5):
        events_ms = cuda_ms(fn, warmup, iters)
        devs = [device_ms(fn, dev_iters, repeats) for _ in range(2)]
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
    from repro_torch.kernels.launches import MODULES

    return dict(MODULES)


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
        if 0 < window < s:  # the bar must see the window: wrong windows fail it
            for wrong in (0, window - min(128, window // 2)):
                off = plain_bshd(q, k, v, True, wrong, blk).float()
                seen = not torch.allclose(off, ref.float(), atol=atol, rtol=rtol)
                print(f"[kernel] {label}: the twin with window {wrong} is off by "
                      f"{(off - ref.float()).abs().max().item():.3e}, "
                      f"{'outside the bar: ok' if seen else 'within the bar: FAIL'}")
                check(seen, f"{label}: the twin with window {wrong} passes the bar")
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
    for b, sq, skv, h, kv, d, dtype, atol, rtol, label in XATTN_CASES:
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, skv, kv, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        out = ops.flash_attention(q, k, v, causal=False)
        ref = plain_bshd(q, k, v, False, 0, 128)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == q.shape,
              f"{label}: {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref.float(), atol=atol, rtol=rtol)
        print(f"[kernel] {label}: B={b} S_q={sq} S_kv={skv} H={h} KV={kv} D={d} bidirectional "
              f"{str(dtype).split('.')[-1]} max_abs_err={err:.3e} (atol {atol}, rtol {rtol}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kernel disagrees with its plain twin: {label}")
        if dtype == torch.bfloat16 and skv >= 1000:  # the bar must see the last keys
            short = plain_bshd(q, k[:, :-64], v[:, :-64], False, 0, 128).float()
            seen = not torch.allclose(short, ref.float(), atol=atol, rtol=rtol)
            print(f"[kernel] {label}: the twin without the last 64 keys is off by "
                  f"{(short - ref.float()).abs().max().item():.3e}, "
                  f"{'outside the bar: ok' if seen else 'within the bar: FAIL'}")
            check(seen, f"{label}: the twin without the last 64 keys passes the bar")
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


def memory_of(cfg, frames: int = SERVE_MEMORY_LEN) -> tuple[str, int, int] | None:
    """The memory a cross-attending config reads, as ``generate``'s extras
    key, its length and its width (``frames`` source frames for seamless,
    whose frontend is a stub); None for any other config."""
    if cfg.cross_attn_every > 0:
        return "image_embeds", cfg.num_patches, cfg.vision_embed_dim
    if cfg.is_encdec:
        return "src_frames", frames, cfg.audio_embed_dim
    return None


def request_memories(cfg, requests: list[dict], seed: int) -> dict[str, torch.Tensor]:
    """Each request's own memory (float32 on the card, drawn from ``seed``
    plus its index), by request id."""
    key, m, w = memory_of(cfg)
    return {r["request_id"]: torch.randn(
        (m, w), generator=torch.Generator(device="cuda").manual_seed(seed + i), device="cuda")
        for i, r in enumerate(requests)}


def set_gates(params: dict, value: float) -> int:
    """Every cross-attention's tanh ``gate`` (0 at init, so the memory would
    reach nothing) set to ``value`` in place; returns how many layers."""
    n = 0
    for key, val in params.items():
        if key == "gate":
            val.fill_(value)
            n += val.shape[0] if val.ndim > 1 else 1
        elif isinstance(val, dict):
            n += set_gates(val, value)
    return n


def served_since(before: dict[str, int]) -> dict[str, int]:
    """What the port's batch handlers counted since ``before`` (an earlier
    ``trace.snapshot()["counters"]``): requests, batches, asked tokens and
    decode slots."""
    got = trace.counters_since(before)
    return {k: got.get(f"serve.{k}", 0)
            for k in ("requests", "batches", "asked_tokens", "decode_slots")}


def prefills() -> int:
    """The engines' prefills so far (``engine.prefill`` spans)."""
    return trace.snapshot()["spans"].get("engine.prefill", {}).get("count", 0)


def make_server(engine, memories: dict[str, torch.Tensor] | None):
    """``serve(requests, batch_size)`` -> (tokens per request, wall seconds
    per batch after the device is done): through the generator's batch
    handler into an in-memory CFS, or, for a config with a memory, through
    ``engine.generate(..., extras=...)`` with the batch's memories stacked,
    since the batch handler passes none (ROADMAP C19)."""
    from repro_torch.launch.serve import serve as serve_handler
    from repro_torch.runtime.store import MemoryStore
    from repro_torch.serve.batcher import pad_prompts, result_tokens

    if memories is None:
        def serve(requests, batch_size):
            sink = MemoryStore()
            seconds = serve_handler(engine, requests, batch_size, sink)
            return [result_tokens(sink, "serve", r["request_id"]) for r in requests], seconds
        return serve
    key = memory_of(engine.cfg)[0]

    def serve(requests, batch_size):
        outs, seconds = [], []
        for i in range(0, len(requests), batch_size):
            batch = requests[i : i + batch_size]
            t0 = time.perf_counter()
            extras = {key: torch.stack([memories[r["request_id"]] for r in batch])}
            outs += engine.generate(pad_prompts(batch), max_new_tokens=NEW_TOKENS,
                                    extras=extras).tolist()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return outs, seconds
    return serve


def phase_slice(arch: str, variant: str, prompt_lens: list[int],
                per_prefill: dict[str, int], after=None) -> tuple[dict, dict]:
    """Serve ``arch`` at a real size; in the first run every kernel of
    ``kernel_modules()`` must launch ``per_prefill[name]`` times per prefill
    (0 for a kernel not named). A config with a memory (``memory_of``) gets
    every gate set to ``GATE`` and each request a seeded memory of its own,
    and is served through ``generate`` (``make_server``).
    ``after(engine, requests, served, tag)``, when given, runs on the same
    engine before it is freed and returns more stats with its launch
    counts under ``"launches"``. Returns the launch counts and the stats."""
    from repro_torch.launch.serve import build_engine, make_requests
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
    memories = None
    if memory_of(cfg) is not None:
        key, m, w = memory_of(cfg)
        n_gates = set_gates(engine.params, GATE)
        memories = request_memories(cfg, requests, seed=100)
        print(f"{tag} every cross-attention gate set to {GATE} (tanh {math.tanh(GATE):.3f}; "
              f"{n_gates} layers; 0 at init, where the memory reaches nothing); each request's "
              f"own seeded {key} of ({m}, {w}); served through generate(..., extras=...), "
              f"not the batch handler (C19)")
    serve = make_server(engine, memories)
    torch.cuda.reset_peak_memory_stats()

    runs = []
    for run in range(2):
        prefills_before = prefills()
        if run == 0:
            for mod in mods.values():
                mod.launches = 0
        outs, seconds = serve(requests, 4)
        if run == 0:
            counts = {name: mod.launches for name, mod in mods.items()}
            n_prefills = prefills() - prefills_before
            want = {name: per_prefill.get(name, 0) * n_prefills for name in mods}
            print(f"{tag} kernel launches {counts} over {n_prefills} prefills "
                  f"({cfg.num_layers} layers; want {want})")
            check(n_prefills > 0 and counts == want,
                  f"kernel launches {counts} on the {arch} path, want {want}")
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
    stats.update(breakdown(engine, requests[:4], tag, serve, memories))
    if after is not None:
        stats.update(after(engine, requests, runs[0][0], tag))
    del engine, serve  # the server holds the engine: free both before the cache
    torch.cuda.empty_cache()
    return counts, stats


class MoeDrops:
    """While entered, the router ``repro_torch.models.moe._route`` (which
    ``moe_fwd`` calls once a call and whose aux it returns) is wrapped so
    that every MoE call's share of dropped (token, choice) pairs lands in
    ``self.shares`` and its kept choices per grouped row in ``self.kept``,
    as tensors on the card (read after the run)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route, self.shares, self.kept = moe, moe._route, [], []

        def counting(x, router, cfg):
            dispatch, combine, aux = self.route(x, router, cfg)
            self.shares.append(aux["dropped_frac"].detach())
            self.kept.append(dispatch.detach().sum((-2, -1)).reshape(-1))
            return dispatch, combine, aux

        moe._route = counting
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route

    def take(self) -> list[float]:
        out = [float(x) for x in self.shares]
        self.shares = []
        return out

    def split(self, real: torch.Tensor, k: int) -> tuple[list[float], list[float]]:
        """For each call since the last ``split``: the dropped share of the
        pairs of the rows where ``real`` (B, S) holds, and the share of all
        of the call's dropped pairs that lie on the other (padded) rows."""
        flat = real.reshape(-1)
        on_real, on_pad = [], []
        for kept in self.kept:
            rows = kept[: flat.numel()]  # the group's own zero rows come last
            dropped = k * kept.numel() - kept.sum()
            on_real.append(float(1 - rows[flat].sum() / (k * flat.sum())))
            on_pad.append(float((k * (~flat).sum() - rows[~flat].sum()) / dropped.clamp(min=1)))
        self.kept = []
        return on_real, on_pad


def moe_checks(engine, requests: list[dict], served: list[list[int]], tag: str,
               n_params_want: int, per_prefill: dict[str, int]) -> dict:
    """An MoE slice at every published width: ``n_params_want`` params;
    the served tokens equal direct ``generate`` on each batch; at one
    prefill and one decode step of a batch of 4, each kernel launches
    ``per_prefill`` times in the prefill and never in the decode step, and
    the share of dropped (token, choice) pairs is printed (C16: a decode
    group of 4 tokens has 1 slot per expert), at the prefill also split
    between the left padding and the prompts' own tokens; and the decode
    cache's bytes per token and layer."""
    from repro_torch.models import count_params, decode_step, model_spec, prefill
    from repro_torch.serve.batcher import pad_prompts
    from repro_torch.tree import leaves

    n_params = count_params(model_spec(engine.cfg))
    check(n_params == n_params_want, f"{n_params} params, want {n_params_want}")
    for i in range(0, len(requests), 4):
        want = engine.generate(pad_prompts(requests[i : i + 4]), max_new_tokens=NEW_TOKENS).tolist()
        check(served[i : i + 4] == want, f"batch {i // 4}: served tokens differ from generate")
    print(f"{tag} served tokens equal direct generate on each of "
          f"{len(requests) // 4} batches")
    cfg = engine.cfg
    mods = kernel_modules()
    tokens = torch.as_tensor(pad_prompts(requests[:4]), dtype=torch.long, device="cuda")
    b, s = tokens.shape
    lens = torch.tensor([len(r["prompt"]) for r in requests[:4]], device="cuda")
    real = torch.arange(s, device="cuda")[None, :] >= s - lens[:, None]  # left padding
    e, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    counts = {}
    with torch.inference_mode(), MoeDrops() as drops:
        zero_launches(mods)
        logits, cache = prefill(engine.params, cfg, {"tokens": tokens}, engine.max_len)
        counts["prefill"] = {name: mod.launches for name, mod in mods.items()}
        at_prefill = drops.take()
        on_real, on_pad = drops.split(real, k)
        zero_launches(mods)
        decode_step(engine.params, cfg, logits.argmax(-1), cache, s)
        counts["decode"] = {name: mod.launches for name, mod in mods.items()}
        at_decode = drops.take()
    want = {"prefill": {n: per_prefill.get(n, 0) for n in mods}, "decode": {n: 0 for n in mods}}
    print(f"{tag} launches at one prefill and one decode step: {json.dumps(counts)}")
    check(counts == want, f"launches {counts}, want {want}")
    caps = {n: max(1, int(min(cfg.moe.group_size, n) * k * cf / e)) for n in (b * s, b)}
    shares = {"prefill": at_prefill, "decode": at_decode}
    for name, n in (("prefill", b * s), ("decode", b)):
        vals = shares[name]
        check(len(vals) == cfg.num_layers, f"{name}: {len(vals)} MoE calls")
        print(f"{tag} dropped (token, choice) pairs at one {name} (B={b}, {n} tokens a group, "
              f"capacity {caps[n]} a expert): mean {sum(vals) / len(vals):.4f} over "
              f"{len(vals)} MoE layers (min {min(vals):.4f}, max {max(vals):.4f})")
    n_pad = int((~real).sum())
    print(f"{tag} at that prefill the left padding is {n_pad} of {b * s} tokens (token 0 "
          f"at the same positions in each row): it holds {sum(on_pad) / len(on_pad):.4f} of "
          f"the dropped pairs (mean over layers; min {min(on_pad):.4f}, max {max(on_pad):.4f}); "
          f"the prompts' own tokens drop {sum(on_real) / len(on_real):.4f} of their pairs "
          f"(min {min(on_real):.4f}, max {max(on_real):.4f})")
    # the cache leaves are stacked (groups, B, slots, ...): bytes per slot and layer
    layer = leaves(cache["layers"])
    per_token = sum(t[0, 0, 0].numel() * t.element_size() for t in layer)
    values = sum(t[0, 0, 0].numel() for t in layer)
    print(f"{tag} decode cache: {values} values, {per_token} bytes per token and layer "
          f"({', '.join(f'{tuple(t.shape)} {t.dtype}' for t in layer)})")
    return {"dropped_prefill": at_prefill, "dropped_prefill_real": on_real,
            "dropped_prefill_on_pad": on_pad, "pad_tokens": n_pad,
            "dropped_decode": at_decode, "capacity": caps,
            "cache_values_per_token_layer": values, "cache_bytes_per_token_layer": per_token,
            "launches": {name: sum(c[name] for c in counts.values()) for name in mods}}


def mixtral_checks(engine, requests: list[dict], served: list[list[int]], tag: str) -> dict:
    """mixtral half-depth: every published width at 16 layers
    (``MIXTRAL_PARAMS``), ``moe_checks``, then ``phase_mixtral_swa``."""
    stats = moe_checks(engine, requests, served, tag, MIXTRAL_PARAMS, MIXTRAL_PER_PREFILL)
    swa_counts, swa = phase_mixtral_swa(engine)
    launches = stats.pop("launches")
    return dict(stats, swa=swa, launches={n: launches[n] + swa_counts[n] for n in launches})


def deepseek_checks(engine, requests: list[dict], served: list[list[int]], tag: str) -> dict:
    """deepseek-v3 two-moe: every published width at 3 dense-prefix and 2
    MoE layers (``DEEPSEEK_PARAMS``), ``moe_checks``; the decode cache
    holds MLA's latent and RoPE key, ``kv_lora_rank + qk_rope_head_dim``
    values a token and layer, against the ``2 * heads * head_dim`` of a
    cache of expanded K and V; then ``phase_mla_absorb``."""
    cfg = engine.cfg
    stats = moe_checks(engine, requests, served, tag, DEEPSEEK_PARAMS, DEEPSEEK_PER_PREFILL)
    values = stats["cache_values_per_token_layer"]
    want = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    gqa = 2 * cfg.num_kv_heads * cfg.head_dim
    itemsize = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    print(f"{tag} MLA cache {values} values ({stats['cache_bytes_per_token_layer']} bytes) per "
          f"token and layer against {gqa} values ({gqa * itemsize} bytes) of a cache of "
          f"{cfg.num_kv_heads} kv heads x {cfg.head_dim}: {gqa / values:.1f}x smaller "
          f"{'ok' if values == want else 'FAIL'}")
    check(values == want, f"MLA cache {values} values a token and layer, want {want}")
    absorb_counts, absorb = phase_mla_absorb(engine)
    launches = stats.pop("launches")
    return dict(stats, mla_absorb=absorb, gqa_cache_values_per_token_layer=gqa,
                launches={n: launches[n] + absorb_counts[n] for n in launches})


def phase_mla_absorb(engine) -> tuple[dict, dict]:
    """[mla-absorb]: the first MoE layer's MLA of the served weights at
    full width in bf16, on the normed embeddings of seeded tokens: the
    expanded ``mla_fwd`` over prompt + 16 (B1, once), a prefill of the
    300-token prompt (B1, once) into an ``init_mla_cache`` of prompt + 16
    slots, then 16 teacher-forced absorbed ``mla_decode`` steps (no B1).
    Each step's output is held to the forward's at its position at
    ``MLA_ABSORB_ATOL``/``RTOL``; as a control, the forward one position
    earlier must fall outside that bar at every step. This checks the
    absorption at full width without the routing, whose decode group is
    not the forward's (C16)."""
    from repro_torch.models import mla
    from repro_torch.models.layers import apply_norm
    from repro_torch.tree import map_leaves

    tag = "[mla-absorb]"
    cfg = engine.cfg
    mods = kernel_modules()
    b, s, n = MLA_ABSORB_BATCH, MLA_ABSORB_PROMPT, NEW_TOKENS
    block = map_leaves(lambda p: p[0], engine.params["groups"]["b0"])
    tokens = torch.randint(0, cfg.vocab_size, (b, s + n),
                           generator=torch.Generator().manual_seed(8)).cuda()
    positions = torch.arange(s + n, device="cuda")
    counts = {}
    with torch.inference_mode():
        x = apply_norm(engine.params["embed"][tokens], block["norm1"], cfg.norm, cfg.norm_eps)
        zero_launches(mods)
        full = mla.mla_fwd(block["mixer"], x, cfg, positions)
        counts["forward"] = {name: mod.launches for name, mod in mods.items()}
        zero_launches(mods)
        _, pre = mla.mla_fwd(block["mixer"], x[:, :s], cfg, positions[:s], return_cache=True)
        counts["prefill"] = {name: mod.launches for name, mod in mods.items()}
        cache = mla.init_mla_cache(cfg, b, s + n, x.dtype, "cuda")
        for key in cache:
            cache[key][:, :s] = pre[key]
        zero_launches(mods)
        steps = []
        for pos in range(s, s + n):
            y, cache = mla.mla_decode(block["mixer"], x[:, pos : pos + 1], cache, pos, cfg)
            steps.append(y[:, 0].float())
        counts["decode"] = {name: mod.launches for name, mod in mods.items()}
    torch.cuda.synchronize()
    errs, off_errs, outside = [], [], 0
    bar = dict(atol=MLA_ABSORB_ATOL, rtol=MLA_ABSORB_RTOL)
    for i, got in enumerate(steps):
        want, early = full[:, s + i].float(), full[:, s + i - 1].float()
        errs.append((got - want).abs().max().item())
        off_errs.append((got - early).abs().max().item())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, **bar)
        outside += not torch.allclose(got, early, **bar)
        check(ok, f"{tag} decode pos {s + i}: max_abs_err {errs[-1]:.3e} outside atol "
              f"{MLA_ABSORB_ATOL}, rtol {MLA_ABSORB_RTOL}")
    scale = full[:, s:].float().abs().max().item()
    print(f"{tag} one MLA layer at full width ({cfg.num_heads} heads, q rank "
          f"{cfg.mla.q_lora_rank}, kv rank {cfg.mla.kv_lora_rank}), bf16, B={b}, prompt {s}: "
          f"{n} absorbed decode steps vs the expanded forward: max_abs_err {max(errs):.3e} "
          f"(per step {' '.join(f'{e:.2e}' for e in errs)}; atol {MLA_ABSORB_ATOL}, rtol "
          f"{MLA_ABSORB_RTOL}; |y| up to {scale:.3e}) ok")
    print(f"{tag} control, the forward one position earlier: off by {min(off_errs):.3e} to "
          f"{max(off_errs):.3e}, outside the bar at {outside} of {n} steps "
          f"{'ok' if outside == n else 'FAIL'}")
    check(outside == n, "the forward one position off passes the bar: the phase cannot see it")
    want_counts = {"forward": {name: int(name == "flash_attention") for name in mods},
                   "prefill": {name: int(name == "flash_attention") for name in mods},
                   "decode": {name: 0 for name in mods}}
    print(f"{tag} launches {json.dumps(counts)}")
    check(counts == want_counts, f"launches {counts}, want {want_counts}")
    total = {name: sum(c[name] for c in counts.values()) for name in mods}
    return total, {"max_abs_err": max(errs), "errs": errs, "off_by_one_min": min(off_errs),
                   "y_max": scale, "launches": counts}


def phase_mixtral_swa(engine) -> tuple[dict, dict]:
    """[mixtral-swa]: the window bites at full width. B=1, a prompt of
    window + 256 tokens: forward over prompt + 16, then prefill the prompt
    and decode 16 tokens teacher-forced past the window through the ring
    cache. Each decode step's logits are held to the forward's at that
    position at the bf16 bar of tests/test_decode_consistency.py (atol
    3e-2, rtol 1e-3); at B=1 no choice drops (C16). B1 must launch once per
    layer in the forward and in the prefill, and never in decode. As a
    control, the forward without the window must fall outside that bar at
    one step at least, or the phase could not tell a B1 that ignores the
    window."""
    from repro_torch.models import decode_step, forward, prefill

    tag = "[mixtral-swa]"
    cfg = engine.cfg
    mods = kernel_modules()
    s = SWA_SHAPE[1]
    check(cfg.sliding_window == SWA_WINDOW, f"window {cfg.sliding_window}")
    tokens = torch.randint(0, cfg.vocab_size, (1, s + NEW_TOKENS),
                           generator=torch.Generator().manual_seed(7)).cuda()
    counts, errs = {}, []
    with torch.inference_mode(), MoeDrops() as drops:
        for mod in mods.values():
            mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = forward(engine.params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        counts["forward"] = {name: mod.launches for name, mod in mods.items()}
        fwd_drops = drops.take()
        for mod in mods.values():
            mod.launches = 0
        last, cache = prefill(engine.params, cfg, {"tokens": tokens[:, :s]}, s + NEW_TOKENS)
        counts["prefill"] = {name: mod.launches for name, mod in mods.items()}
        check(cache["layers"]["b0"]["k"].shape[2] == SWA_WINDOW,
              f"ring cache {tuple(cache['layers']['b0']['k'].shape)}")
        drops.take()
        for mod in mods.values():
            mod.launches = 0
        pairs = [(last[:, 0], logits[:, s - 1])]
        for pos in range(s, s + NEW_TOKENS):
            dl, cache = decode_step(engine.params, cfg, tokens[:, pos : pos + 1], cache, pos)
            pairs.append((dl[:, 0], logits[:, pos]))
        counts["decode"] = {name: mod.launches for name, mod in mods.items()}
        dec_drops = drops.take()
        # the control: the same forward without the window
        windowless, _ = forward(engine.params, cfg.copy(sliding_window=0), {"tokens": tokens})
        drops.take()
    for i, (got, want) in enumerate(pairs):
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=3e-2, rtol=1e-3)
        errs.append(err)
        what = "prefill's last" if i == 0 else f"decode pos {s + i - 1}"
        print(f"{tag} {what} vs forward: max_abs_err {err:.3e} (atol 3e-2, rtol 1e-3) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{what} differs from the forward")
    # The phase sees the window only if a forward without it (what a B1
    # that ignored the window would give) falls outside the bar somewhere.
    off = [(got.float(), windowless[:, s + i - 1].float()) for i, (got, _) in enumerate(pairs)
           if i > 0]
    off_errs = [(g - w).abs().max().item() for g, w in off]
    outside = sum(not torch.allclose(g, w, atol=3e-2, rtol=1e-3) for g, w in off)
    rms = {name: math.sqrt(sum(float(((g - w) ** 2).mean()) for g, w in p) / len(p))
           for name, p in (("forward", [(g.float(), w.float()) for g, w in pairs[1:]]),
                           ("windowless", off))}
    print(f"{tag} control, the forward without the window: decode is off by max_abs_err "
          f"{max(off_errs):.3e} (min over steps {min(off_errs):.3e}), outside the bar at "
          f"{outside} of {len(off)} steps; rms over the steps {rms['windowless']:.3e} vs "
          f"{rms['forward']:.3e} against the forward with the window "
          f"{'ok' if outside else 'FAIL'}")
    check(outside > 0, "decode agrees with a forward without the window: the phase cannot "
          "see the window")
    layers = cfg.num_layers
    want = {"forward": {n: layers if n == "flash_attention" else 0 for n in mods},
            "prefill": {n: layers if n == "flash_attention" else 0 for n in mods},
            "decode": {n: 0 for n in mods}}
    print(f"{tag} B=1, prompt {s} tokens (window {SWA_WINDOW} + {s - SWA_WINDOW}), "
          f"{NEW_TOKENS} decode steps past the window: forward {forward_s:.4f} s; launches "
          f"{json.dumps(counts)}; dropped share forward max {max(fwd_drops):.4f}, decode max "
          f"{max(dec_drops):.4f}")
    check(counts == want, f"launches {counts}, want {want}")
    check(max(dec_drops) == 0.0, f"decode dropped choices at B=1: {dec_drops}")
    total = {n: sum(c[n] for c in counts.values()) for n in mods}
    return total, {"max_abs_err": max(errs), "forward_s": forward_s,
                   "windowless_max_abs_err": max(off_errs), "windowless_outside": outside,
                   "rms": rms,
                   "dropped_forward_max": max(fwd_drops), "launches": counts}


def xattn_checks(engine, requests: list[dict], served: list[list[int]], tag: str) -> dict:
    """A cross-attending slice at every published width and depth: its
    param count, then ``phase_xattn_decode``."""
    from repro_torch.models import count_params, model_spec

    want = {"llama-3.2-vision-11b": VISION_PARAMS,
            "seamless-m4t-large-v2": SEAMLESS_PARAMS}[engine.cfg.name]
    n_params = count_params(model_spec(engine.cfg))
    check(n_params == want, f"{n_params} params, want {want}")
    counts, stats = phase_xattn_decode(engine)
    return {"xattn_decode": stats, "launches": counts}


def xattn_decode_run(params: dict, cfg) -> dict:
    """B=1, a seeded prompt of ``XATTN_DECODE_PROMPT`` tokens plus 16, with
    its own seeded memory: the forward over all of them, a prefill of the
    prompt, 16 teacher-forced decode steps (the cross-attention reads the
    cached memory K/V in plain torch), and the forward on another request's
    memory. Returns, for the prefill's last and each decode step, the
    largest and the rms distance to the forward's logits and (decode steps)
    to the other memory's, the logits' largest magnitude, and each run's
    launches."""
    from repro_torch.models import decode_step, forward, prefill

    mods = kernel_modules()
    s, n = XATTN_DECODE_PROMPT, NEW_TOKENS
    key = memory_of(cfg)[0]
    tokens = torch.randint(0, cfg.vocab_size, (1, s + n),
                           generator=torch.Generator().manual_seed(9)).cuda()
    mem, other = (request_memories(cfg, [{"request_id": i}], seed)[i][None]
                  for i, seed in ((0, 200), (1, 300)))
    counts = {}
    with torch.inference_mode():
        zero_launches(mods)
        logits, _ = forward(params, cfg, {"tokens": tokens, key: mem})
        counts["forward"] = {name: mod.launches for name, mod in mods.items()}
        zero_launches(mods)
        last, cache = prefill(params, cfg, {"tokens": tokens[:, :s], key: mem}, s + n)
        counts["prefill"] = {name: mod.launches for name, mod in mods.items()}
        zero_launches(mods)
        steps = [(last[:, 0], s - 1)]
        for pos in range(s, s + n):
            dl, cache = decode_step(params, cfg, tokens[:, pos : pos + 1], cache, pos)
            steps.append((dl[:, 0], pos))
        counts["decode"] = {name: mod.launches for name, mod in mods.items()}
        zero_launches(mods)
        moved, _ = forward(params, cfg, {"tokens": tokens, key: other})
        counts["control"] = {name: mod.launches for name, mod in mods.items()}
    out = {"max": [], "rms": [], "ctrl_max": [], "ctrl_rms": [], "got": [], "want": [],
           "ctrl": [], "logits_max": logits[:, s - 1 :].float().abs().max().item(),
           "launches": counts}
    for got, pos in steps:
        got, want, ctrl = got.float(), logits[:, pos].float(), moved[:, pos].float()
        out["max"].append((got - want).abs().max().item())
        out["rms"].append((got - want).pow(2).mean().sqrt().item())
        out["got"].append(got)
        out["want"].append(want)
        if pos >= s:
            out["ctrl_max"].append((got - ctrl).abs().max().item())
            out["ctrl_rms"].append((got - ctrl).pow(2).mean().sqrt().item())
            out["ctrl"].append(ctrl)
    return out


def phase_xattn_decode(engine) -> tuple[dict, dict]:
    """[xattn-decode]: ``xattn_decode_run`` at full width with every gate at
    ``GATE``, first on the served bf16 weights, then on a float32 copy of
    them. In float32 each step's logits (and the prefill's last) are held to
    the forward's at ``XATTN_DECODE_ATOL``/``RTOL``, and, as a control, the
    forward on another request's memory must fall outside that bar at every
    step: the memory reaches the logits through the gates, and the bar sees
    it. In bf16 the distances are printed beside the control's (decode's
    bf16 scores and B1's float32 scores round apart, by about as much as
    another memory moves seamless's logits). B1 launches a prefill's count
    in each forward and in the prefill, never in decode."""
    from repro_torch.tree import map_leaves

    cfg = engine.cfg
    tag = f"[xattn-decode] {cfg.name}"
    mods = kernel_modules()
    key, m, w = memory_of(cfg)
    head = (f"{tag} B=1, prompt {XATTN_DECODE_PROMPT}, {key} ({m}, {w}), gates {GATE}: the "
            f"prefill's last and {NEW_TOKENS} decode steps vs the forward")
    bf16 = xattn_decode_run(engine.params, cfg)
    print(f"{head}, bf16 (no bar): max_abs_err {max(bf16['max']):.3e}, rms "
          f"{min(bf16['rms'][1:]):.3e} to {max(bf16['rms'][1:]):.3e} a step; the forward on "
          f"another memory: max {min(bf16['ctrl_max']):.3e} to {max(bf16['ctrl_max']):.3e}, rms "
          f"{min(bf16['ctrl_rms']):.3e} to {max(bf16['ctrl_rms']):.3e}; |logits| up to "
          f"{bf16['logits_max']:.3e}")
    params32 = map_leaves(lambda t: t.float(), engine.params)
    f32 = xattn_decode_run(params32, cfg.copy(param_dtype="float32", compute_dtype="float32"))
    del params32
    torch.cuda.empty_cache()
    bar = dict(atol=XATTN_DECODE_ATOL, rtol=XATTN_DECODE_RTOL)
    for i, (got, want) in enumerate(zip(f32["got"], f32["want"])):
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, **bar)
        check(ok, f"{tag} float32 step {i}: max_abs_err {f32['max'][i]:.3e} outside atol "
              f"{XATTN_DECODE_ATOL}, rtol {XATTN_DECODE_RTOL}")
    outside = sum(not torch.allclose(got, ctrl, **bar)
                  for got, ctrl in zip(f32["got"][1:], f32["ctrl"]))
    print(f"{head}, float32 copy: max_abs_err {max(f32['max']):.3e} (per step "
          f"{' '.join(f'{e:.2e}' for e in f32['max'])}; atol {XATTN_DECODE_ATOL}, rtol "
          f"{XATTN_DECODE_RTOL}; |logits| up to {f32['logits_max']:.3e}) ok")
    print(f"{tag} control, the float32 forward on another request's memory: off by "
          f"{min(f32['ctrl_max']):.3e} to {max(f32['ctrl_max']):.3e}, outside the bar at "
          f"{outside} of {NEW_TOKENS} steps {'ok' if outside == NEW_TOKENS else 'FAIL'}")
    check(outside == NEW_TOKENS, "the forward on another memory passes the bar: the phase "
          "cannot see the memory")
    per = {"llama-3.2-vision-11b": VISION_PER_PREFILL,
           "seamless-m4t-large-v2": SEAMLESS_PER_PREFILL}[cfg.name]
    want = {phase: {name: 0 if phase == "decode" else per.get(name, 0) for name in mods}
            for phase in f32["launches"]}
    for run in (bf16, f32):
        check(run["launches"] == want, f"{tag} launches {run['launches']}, want {want}")
    print(f"{tag} launches in each of the two runs {json.dumps(f32['launches'])}")
    total = {name: sum(c[name] for run in (bf16, f32) for c in run["launches"].values())
             for name in mods}
    keep = ("max", "rms", "ctrl_max", "ctrl_rms", "logits_max")
    return total, {"bf16": {k: bf16[k] for k in keep}, "float32": {k: f32[k] for k in keep},
                   "launches": f32["launches"]}


def eager_decode(engine, batch: dict, new: int) -> tuple[list, torch.Tensor, float, float]:
    """A prefill and ``new - 1`` eager ``decode_step`` calls at int
    positions on the engine's weights, greedy, outside the engine: (the
    tokens (B, new) as lists, the first decode step's logits, prefill s,
    decode s a step), timed to the device's end."""
    from repro_torch.models import decode_step, prefill

    s = batch["tokens"].shape[1]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(engine.params, engine.cfg, batch, engine.max_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, first = [logits.argmax(-1)], None
        for pos in range(s, s + new - 1):
            logits, cache = decode_step(engine.params, engine.cfg, out[-1], cache, pos)
            first = logits if first is None else first
            out.append(logits.argmax(-1))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return torch.cat(out, 1).tolist(), first, t1 - t0, (t2 - t1) / (new - 1)


def engine_step(engine, b: int, tag: str):
    """The engine's one greedy decode key of batch size ``b``, with its
    graph: one capture per key."""
    steps = [st for key, st in engine.steps.items() if key[0] == b and not key[1]]
    graphs = sum(st.graph is not None for st in engine.steps.values())
    print(f"{tag} engine: {len(engine.steps)} decode keys, {graphs} captured graphs")
    check(len(steps) == 1 and graphs == len(engine.steps),
          f"{len(steps)} greedy keys of B={b}, {graphs} graphs for {len(engine.steps)} keys")
    return steps[0]


def profile_window(fn, tag: str, label: str) -> tuple[float, float] | None:
    """(wall s, device busy s) of ``fn()`` under ``torch.profiler``, the
    idle share printed with the 8 kernels of most device time (and the
    port's kernels below them); None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = sorted(
        ((e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[2])
    if not kernels:
        print(f"{tag} {label}: the profiler recorded no device time: busy share not measured")
        return None
    busy_s = sum(r[2] for r in kernels) / 1e6
    print(f"{tag} {label}: wall {wall_s:.4f} s, device busy {busy_s:.4f} s, idle share "
          f"{1 - busy_s / wall_s:.4f} (profiler overhead included)")
    port = ("flash_fwd_", "wkv6_fwd_kernel", "mamba_scan_fwd_kernel")  # the port's kernels
    ours = [r for r in kernels[8:] if any(name in r[0] for name in port)]  # if not on top
    for name, count, us in kernels[:8] + ours:
        print(f"{tag}   {us / 1e3:10.3f} ms {count:6d}x {us / 1e6 / busy_s:7.2%} {name[:90]}")
    return wall_s, busy_s


def breakdown(engine, requests: list[dict], tag: str, serve,
              memories: dict[str, torch.Tensor] | None = None) -> dict:
    """Where one batch's time goes, eager against captured. Eager: a
    prefill and an eager ``decode_step`` loop, timed, and its peak.
    Captured: the same batch through ``engine.generate`` (its decode key's
    one CUDA graph) must give the eager loop's greedy tokens for all
    ``NEW_TOKENS``; then one prefill loaded into the key's step, whose
    first replay's logits are held to the eager first step's and whose
    other replays are timed; then a profiler window over ``serve``
    (``make_server``'s) for the device's busy share, and its peak."""
    from repro_torch.models import prefill
    from repro_torch.serve.batcher import pad_prompts

    t_start = time.perf_counter()
    prompts = pad_prompts(requests)
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=engine.device)
    batch, extras = {"tokens": tokens}, {}
    if memories is not None:
        extras[memory_of(engine.cfg)[0]] = torch.stack([memories[r["request_id"]]
                                                        for r in requests])
        batch.update(extras)
    b, s = tokens.shape
    torch.cuda.reset_peak_memory_stats()
    eager, first, prefill_s, decode_step_s = eager_decode(engine, batch, NEW_TOKENS)
    eager_peak = torch.cuda.max_memory_allocated()
    print(f"{tag} breakdown: B={b} S={s}: prefill {prefill_s:.4f} s, eager decode "
          f"{decode_step_s * 1e3:.3f} ms/step; peak {eager_peak} bytes")

    served = engine.generate(prompts, max_new_tokens=NEW_TOKENS, extras=extras).tolist()
    check(served == eager, "the captured engine's greedy tokens differ from the eager loop's")
    step = engine_step(engine, b, tag)
    with torch.inference_mode():
        logits, cache = prefill(engine.params, engine.cfg, batch, engine.max_len)
        step.load(cache, logits.argmax(-1), s)
        del logits, cache
        step.run(1)
        first_diff = (step.logits.float() - first.float()).abs().max().item()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.run(NEW_TOKENS - 2)
        torch.cuda.synchronize()
        captured_step_s = (time.perf_counter() - t0) / (NEW_TOKENS - 2)
        replayed = step.out[:, s : s + NEW_TOKENS].tolist()
    check(replayed == eager, "the replayed steps' tokens differ from the eager loop's")
    print(f"{tag} captured engine: greedy tokens equal the eager loop's for all {NEW_TOKENS}; "
          f"decode {captured_step_s * 1e3:.3f} ms/step (eager {decode_step_s * 1e3:.3f}); "
          f"first step's logits: largest difference {first_diff:.3e} "
          f"({'bit-identical' if first_diff == 0 else f'bar {CAPTURED_LOGITS_BAR}'})")
    check(first_diff <= CAPTURED_LOGITS_BAR, f"first step's logits differ by {first_diff}")
    torch.cuda.reset_peak_memory_stats()
    window = profile_window(lambda: serve(requests, len(requests)), tag,
                            "profiled captured batch (through the engine)")
    captured_peak = torch.cuda.max_memory_allocated()
    print(f"{tag} peak: eager {eager_peak} bytes, captured engine {captured_peak} bytes; "
          f"breakdown {time.perf_counter() - t_start:.1f} s")
    stats = {"prefill_s": prefill_s, "decode_step_s": decode_step_s,
             "captured_step_s": captured_step_s, "first_logits_diff": first_diff,
             "eager_peak_bytes": eager_peak, "captured_peak_bytes": captured_peak}
    if window is not None:
        stats["profiled_wall_s"], stats["profiled_busy_s"] = window
    return stats


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


def reseed_gates(params: dict, gen: torch.Generator) -> None:
    """Every cross-attention gate at ``GATE`` (0 at init)."""
    set_gates(params, GATE)


def prefill_launches(cfg) -> dict[str, int]:
    """Each kernel of ``kernel_modules()``'s launches in one forward or
    prefill: one a layer of every stack (the dense prefix's and the
    encoder's too), by its mixer, and two for seamless's decoder layers
    (self- and cross-attention)."""
    from repro_torch.models.model import encoder_layout, main_layout, prefix_layout

    kernel_of = {"attn": {"flash_attention": 1}, "mla": {"flash_attention": 1},
                 "xattn": {"flash_attention": 1}, "attn_x": {"flash_attention": 2},
                 "rwkv": {"rwkv6_wkv": 1}, "mamba": {"mamba_scan": 1}}
    out = {name: 0 for name in kernel_modules()}
    stacks = [main_layout(cfg)] + ([prefix_layout(cfg)] if cfg.dense_prefix_layers else []) + (
        [encoder_layout(cfg)] if cfg.is_encdec else [])
    for layout in stacks:
        for block in layout.group:
            for name, n in kernel_of[block.mixer].items():
                out[name] += n * layout.num_groups
    return out


def phase_cross_device(arch: str, variant: str, t: int, reseed=None) -> dict[str, int]:
    """A smoke config in f32 on the card (kernels) against the CPU (plain
    twins), on the same weights (and, for a config with a memory, the same
    seeded memory: 17 patches, or 40 frames for seamless, gates at
    ``GATE``): logits and greedy tokens; the card launches each kernel
    ``prefill_launches`` times in the forward and again in generate's
    prefill, never in its decode steps. Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, model_spec
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch, variant).copy(
        param_dtype="float32", compute_dtype="float32", use_pallas=True)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    if reseed is not None:
        reseed(params, torch.Generator().manual_seed(4))
    tokens = torch.randint(0, cfg.vocab_size, (2, t), generator=torch.Generator().manual_seed(1))
    extras = {}
    if memory_of(cfg) is not None:
        key, m, w = memory_of(cfg, frames=40)
        extras[key] = torch.randn((2, m, w), generator=torch.Generator().manual_seed(2))
    on_cpu = ServeEngine(cfg, params, max_len=t + 24, device="cpu")
    on_gpu = ServeEngine(cfg, params, max_len=t + 24, device="cuda")
    mods = kernel_modules()
    with torch.inference_mode():
        lc, _ = forward(on_cpu.params, cfg, {"tokens": tokens, **extras})
        zero_launches(mods)
        lg, _ = forward(on_gpu.params, cfg,
                        {"tokens": tokens.cuda(), **{k: v.cuda() for k, v in extras.items()}})
        counts = {name: mod.launches for name, mod in mods.items()}
    err = (lg.cpu() - lc).abs().max().item()
    ok = torch.allclose(lg.cpu(), lc, atol=5e-3, rtol=1e-3)
    print(f"[cross] {arch} {variant} f32, T={t}: logits cuda vs cpu max_abs_err={err:.3e} "
          f"(atol 5e-3, rtol 1e-3) {'ok' if ok else 'FAIL'}")
    check(ok, f"{arch} logits differ between the card and the CPU")
    tc = on_cpu.generate(tokens.numpy(), max_new_tokens=NEW_TOKENS, extras=extras)
    zero_launches(mods)
    tg = on_gpu.generate(tokens.numpy(), max_new_tokens=NEW_TOKENS, extras=extras)
    counts = {name: counts[name] + mod.launches for name, mod in mods.items()}
    print(f"[cross] {arch} greedy tokens identical: {(tc == tg).all()}")
    check((tc == tg).all(), f"{arch} greedy tokens differ between the card and the CPU")
    want = {name: 2 * n for name, n in prefill_launches(cfg).items()}
    print(f"[cross] {arch} launches on the card (forward and generate): {counts}")
    check(counts == want, f"{arch} launches {counts}, want {want}")
    return counts


def wkv_bound(bh: int, t: int, dk: int, dv: int, chunk: int) -> tuple[float, int, float, int]:
    """(ms, operations, ms, bytes): the least time for the operations at the
    float32 peak outside the tensor cores, and for the bytes (each input
    read once, each output written once) at the memory rate. The
    operations are ``rwkv6.operations``, which the custom op's count
    (``repro_torch::rwkv6_chunked``) also gives."""
    from repro_torch.kernels import rwkv6 as wkv

    ops = wkv.operations(bh, t, dk, dv, chunk)
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
    ``x_bytes`` an element, each output written once) at the memory rate
    (``mamba_scan.operations``, the custom op's count)."""
    from repro_torch.kernels import mamba_scan as ms

    ops = ms.operations(b, t, di, n)
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
                     plain_iters: int, window: int = 0, atol: float = 3e-2,
                     rtol: float = 3e-2, v_width: int = 0, s_kv: int = 0,
                     causal: bool = True) -> dict:
    """B1 in bf16, causal (within ``window`` when it is > 0) or
    bidirectional, at ``shape`` = (B, S, H, KV, D) on the kernel's (B*H,
    S, D) layout, k and v ``s_kv`` rows long when it is > 0 (cross-attention;
    bidirectional): kernel, plain twin and SDPA (the same function on (B, H,
    S, D): GQA by ``enable_gqa``; with a window, k and v repeated to H heads
    before the timed call and the window as a boolean mask), beside the
    bound. Kernel and SDPA are timed twice: by CUDA events over
    back-to-back calls, and by their device time alone. With ``v_width`` >
    0, v's columns from ``v_width`` on are zero, as MLA pads V: the bound
    counts the padded function's work, and the share of it that the padding
    adds is printed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import causal_mask

    b, s, h, kv, d = shape
    s_kv = s_kv or s
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b * kv, s_kv, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    if v_width > 0:
        v[..., v_width:] = 0
    group = h // kv
    opts = {"group": group, "causal": causal, "window": window}
    out = fa.flash_attention_cuda(q, k, v, **opts)
    ref = fa.flash_attention_plain(q, k, v, **opts)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol),
          f"flash timing shape {label} disagrees: {err} (atol {atol}, rtol {rtol})")
    pairs = fa.attention_pairs(s, s_kv, causal, window)
    flops = 4 * b * h * d * pairs  # q.k and p.v over the visible pairs (fa.operations)
    nbytes = 2 * b * d * (2 * h * s + 2 * kv * s_kv)  # q, k, v read once and o written once, bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    padding = {}
    if v_width > 0:  # without the padding: p.v and v, o at v_width columns
        unpadded_bytes = 2 * b * s * (h * d + kv * d + kv * v_width + h * v_width)
        padding = {"ops_share": 1 - 2 * b * h * pairs * (d + v_width) / flops,
                   "bytes_share": 1 - unpadded_bytes / nbytes}
        print(f"[time] flash {label}: V padded from {v_width} to {d}: the padding adds "
              f"{padding['ops_share']:.4f} of the operations and {padding['bytes_share']:.4f} of "
              f"the bytes of the padded function")
    kernel_ms, kernel_dev = timed(
        lambda: fa.flash_attention_cuda(q, k, v, **opts), 3, 20, 50,
        max(t_ops, t_bytes), f"flash {label}")
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **opts), 1, plain_iters)
    q4, k4, v4 = q.view(b, h, s, d), k.view(b, kv, s_kv, d), v.view(b, kv, s_kv, d)
    if window > 0:
        k4, v4 = (t.repeat_interleave(group, dim=1) for t in (k4, v4))
        mask = causal_mask(s, s, window=window, device=q.device)

    def sdpa():
        if window > 0:
            return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=group > 1)

    library_ms, library_dev = timed(sdpa, 3, 20, 50, max(t_ops, t_bytes), f"sdpa {label}",
                                    repeats=True)
    kind = f"causal, window {window}" if causal else f"bidirectional, S_kv={s_kv}"
    print(f"[time] flash {label}: B={b} S={s} H={h} KV={kv} D={d} bf16 {kind}: kernel "
          f"{kernel_ms:.4f} ms (device {kernel_dev:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms (device {library_dev:.4f} ms); bound {max(t_ops, t_bytes):.4f} ms "
          f"({flops:.4g} ops -> {t_ops:.4f} ms, {nbytes} bytes -> {t_bytes:.4f} ms); "
          f"{flops / kernel_dev / 1e9:.1f} TFLOP/s on the device; max_abs_err {err:.3e}")
    return {"shape": list(shape), "ms": kernel_ms, "device_ms": kernel_dev, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "err": err,
            **({"padding": padding} if padding else {})}


def phase_timing(worst_err: float, launches: int) -> tuple[dict, dict]:
    gen = torch.Generator(device="cuda").manual_seed(2)
    main = flash_timing_row("prefill", TIMING_SHAPE, gen, 5)
    serving = {label: flash_timing_row(label, shape, gen, 20)
               for label, shape in FLASH_SERVING_SHAPES.items()}
    serving["mixtral window 4096, S=4352"] = flash_timing_row(
        "mixtral window 4096, S=4352", SWA_SHAPE, gen, 3, window=SWA_WINDOW,
        atol=MIXTRAL_BF16_ATOL, rtol=MIXTRAL_BF16_RTOL)
    serving["MLA prefill S=300, D=192"] = flash_timing_row(
        "MLA prefill S=300, D=192", (4, 300, MLA_HEADS, MLA_HEADS, MLA_HEAD_DIM), gen, 5,
        atol=MIXTRAL_BF16_ATOL, rtol=MIXTRAL_BF16_RTOL, v_width=MLA_V_DIM)
    for label, shape, s_kv in XATTN_TIMING_SHAPES:
        serving[label] = flash_timing_row(label, shape, gen, 5, atol=MIXTRAL_BF16_ATOL,
                                          rtol=MIXTRAL_BF16_RTOL, s_kv=s_kv, causal=False)
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
    through the custom op ``repro_torch::flash_attention``, whose gradient
    (``::flash_attention_backward``) recomputes through the plain twin; it
    launches the kernel once and returns its output; dq/dk/dv match
    autograd through the plain twin on the card. Then the WKV and scan
    ops (``phase_grad_scans``). Returns the
    worst errors and the attention backward's time at stablelm's training
    shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

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
        check(fa.launches == before + 1
              and any(B1_BACKWARD_NODE in name for name in grad_fn_names(out)),
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
        check(ok, f"B1's gradients disagree with the plain twin's: {label}")
        worst = max(worst, *errs)
    print(f"[grad] largest gradient error against autograd through the plain twin: {worst:.3e}")

    scan_worst = phase_grad_scans(gen)

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
    return {"worst_err": worst, "fwd_ms": fwd_ms, "bwd_ms": both_ms - fwd_ms, **scan_worst}


def grads_against_twin(label: str, fn, twin, args: tuple[torch.Tensor, ...], mod, node: str,
                       names: str) -> float:
    """``fn`` (the kernel's wrapper in ``ops``) under grad launches its
    kernel once, through its custom op (the autograd node ``node``), and
    none in the backward; its gradients equal autograd through ``twin`` on
    the card at the kernels' f32 bar and are finite. Returns the largest
    difference."""
    gen = torch.Generator(device="cuda").manual_seed(len(label))
    live = [a.clone().requires_grad_() for a in args]
    before = mod.launches
    outs = fn(*live)
    graph = grad_fn_names(outs[0])
    check(mod.launches == before + 1 and any(node in name for name in graph),
          f"{label}: {mod.launches - before} launches, graph {graph}")
    cots = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]
    got = torch.autograd.grad(sum((o.float() * c).sum() for o, c in zip(outs, cots)), live)
    check(mod.launches == before + 1, f"{label}: the backward launched the kernel")
    ref_in = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(
        sum((o.float() * c).sum() for o, c in zip(twin(*ref_in), cots)), ref_in)
    torch.cuda.synchronize()
    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
    ok = all(g.dtype == a.dtype and bool(torch.isfinite(g.float()).all()) and torch.allclose(
        g.float(), w.float(), atol=WKV_ATOL, rtol=WKV_RTOL) for g, w, a in zip(got, want, args))
    print(f"[grad] {label}: one launch, max_abs_err "
          f"{' '.join(f'd{n} {e:.3e}' for n, e in zip(names.split(), errs))} "
          f"(atol {WKV_ATOL}, rtol {WKV_RTOL}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: gradients disagree with autograd through the plain twin")
    return max(errs)


def wkv_model_inputs(b: int, t: int, h: int, k: int, gen: torch.Generator,
                     logw: float | None = None) -> tuple[torch.Tensor, ...]:
    """``wkv_inputs``' draw at the model's layout, as ``ops.rwkv6_chunked``
    takes it: r, k, v, logw (B, T, H, K), one bonus u (H, K) for every
    batch row, s0 (B, H, K, V)."""
    r, kk, v, lw, u, s0 = wkv_inputs(b, t, h, k, gen, True, logw)
    return (*(x.reshape(b, h, t, k).transpose(1, 2).contiguous() for x in (r, kk, v, lw)),
            u.reshape(b, h, k)[0].contiguous(), s0.reshape(b, h, k, k))


def wkv_twin_model(r, k, v, logw, u, s0, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``rwkv6_plain`` at the model's layout: flattened to (B·H, T, K) and
    back here, apart from the op's own layout code."""
    from repro_torch.kernels import rwkv6 as wkv

    b, t, h, dk = r.shape

    def flat(x):
        return x.transpose(1, 2).reshape(b * h, t, x.shape[-1])

    out, s = wkv.rwkv6_plain(flat(r), flat(k), flat(v), flat(logw),
                             u[None].expand(b, h, dk).reshape(b * h, 1, dk),
                             s0.reshape(b * h, dk, -1), chunk=chunk)
    return out.reshape(b, h, t, -1).transpose(1, 2), s.reshape(b, h, dk, -1)


def phase_grad_scans(gen: torch.Generator) -> dict:
    """``ops.rwkv6_chunked`` and ``ops.mamba_chunk_scan`` under grad, at
    the model's layout as the models call them (their custom ops, whose
    backward ops recompute through the twins), against autograd through
    their plain twins on the card; then one layer's backward timed at the
    smoke train step."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6 as wkv

    worst = {"wkv_grad_err": 0.0, "mamba_grad_err": 0.0}
    timed_layers = {}
    for label, b, t, h, k, chunk, logw in WKV_GRAD_CASES:
        args = wkv_model_inputs(b, t, h, k, gen, logw)
        fn = lambda *a, c=chunk: ops.rwkv6_chunked(*a, chunk=c)  # noqa: E731
        err = grads_against_twin(
            f"rwkv6_chunked {label}: B={b} T={t} H={h} K=V={k} chunk {chunk}", fn,
            lambda *a, c=chunk: wkv_twin_model(*a, c), args, wkv, "repro_torch_rwkv6_chunked",
            "r k v logw u s0")
        worst["wkv_grad_err"] = max(worst["wkv_grad_err"], err)
        timed_layers.setdefault("rwkv6_chunked", (fn, args))
    for label, b, t, di, n, chunk, x_dtype in MAMBA_GRAD_CASES:
        args = mamba_inputs(b, t, di, n, gen, True, "reference", x_dtype)
        fn = lambda *a, c=chunk, d=di: ops.mamba_chunk_scan(*a, chunk=c, d_block=d)  # noqa: E731
        err = grads_against_twin(
            f"mamba_chunk_scan {label}: B={b} T={t} DI={di} N={n} chunk {chunk}", fn,
            lambda *a, c=chunk, d=di: ms.mamba_scan_plain(*a[:4], a[4].float(), a[5], chunk=c,
                                                          d_block=d),
            args, ms, "repro_torch_mamba_chunk_scan", "dt B C A x h0")
        worst["mamba_grad_err"] = max(worst["mamba_grad_err"], err)
        timed_layers.setdefault("mamba_chunk_scan", (fn, args))

    # one layer's backward at the smoke train step: the kernel forward, then
    # the recomputation through the twin
    for name, (fn, args) in timed_layers.items():
        live = [a.clone().requires_grad_() for a in args]

        def fwd_bwd():
            outs = fn(*live)
            torch.autograd.grad(sum(o.sum() for o in outs), live)

        fwd_ms = cuda_ms(lambda: fn(*args), 2, 10)
        both_ms = cuda_ms(fwd_bwd, 2, 10)
        worst[f"{name}_fwd_ms"], worst[f"{name}_bwd_ms"] = fwd_ms, both_ms - fwd_ms
        print(f"[grad] {name} at a smoke train step's layer: forward (kernel) {fwd_ms:.4f} ms, "
              f"forward + backward (recomputation through the plain twin) {both_ms:.4f} ms, so "
              f"the backward {both_ms - fwd_ms:.4f} ms")
    return worst


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors."""
    from repro_torch.tree import leaves

    seen = {}
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def dryrun_predict(name: str, seq_len: int, batch: int, kind: str, tcfg=None) -> dict:
    """``run_cell`` of stablelm-3b full on a (1, 1) mesh of fake CUDA
    tensors (torch's fake process group of one rank): the per-device FLOPs,
    the predicted peak (arguments + temporaries) and the roofline terms.
    Nothing is allocated, and no kernel launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun_lib import run_cell
    from repro_torch.launch.mesh import MeshShape, fake_world, make_mesh

    mods = kernel_modules()
    before = {n: m.launches for n, m in mods.items()}
    t0 = time.perf_counter()
    with fake_world(1):
        mesh = make_mesh(MeshShape((1, 1), ("data", "model")), "cuda")
        rec = run_cell("stablelm-3b", ShapeConfig(name, seq_len, batch, kind), mesh, tcfg=tcfg)
    wall = time.perf_counter() - t0
    check(rec["status"] == "ok", f"[dryrun] {name}: {rec.get('error')}\n{rec.get('traceback')}")
    check({n: m.launches for n, m in mods.items()} == before, f"[dryrun] {name}: the trace launched")
    m = rec["memory_analysis"]
    rec["predicted_peak"] = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
    rec["predict_wall_s"] = wall
    return rec


def dryrun_line(name: str, rec: dict, flops: float | None, peak: int, ms: float,
                launches: dict) -> dict:
    """Print and return one cell's predicted against measured numbers; the
    measured roofline fraction is the ideal time, ``model_flops`` at the
    card's peak, over the measured time."""
    r = rec["roofline"]
    predicted_ms = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
    ideal_ms = r["model_flops_total"] / PEAK_BF16_FLOPS * 1e3
    row = {"flops_predicted": r["flops_per_device"], "flops_measured": flops,
           "peak_predicted": rec["predicted_peak"], "peak_measured": peak,
           "peak_ratio": rec["predicted_peak"] / peak, "ms_predicted": predicted_ms,
           "ms_measured": ms, "bottleneck": r["bottleneck"], "ideal_ms": ideal_ms,
           "roofline_fraction_measured": ideal_ms / ms, "launches": launches,
           "trace_s": rec["compile_s"], "predict_wall_s": rec["predict_wall_s"]}
    print(f"[dryrun] {name}: FLOPs predicted {r['flops_per_device']:.6e} measured "
          f"{'(not counted)' if flops is None else f'{flops:.6e}'}; peak predicted "
          f"{rec['predicted_peak']} B measured {peak} B (ratio {row['peak_ratio']:.4f}); time "
          f"predicted {predicted_ms:.3f} ms ({r['bottleneck']}-bound) measured {ms:.3f} ms; "
          f"measured roofline fraction {ideal_ms / ms:.4f} (ideal {ideal_ms:.3f} ms); launches "
          f"{launches}; trace {rec['compile_s']} s")
    check(abs(row["peak_ratio"] - 1) <= DRYRUN_PEAK_RTOL,
          f"[dryrun] {name}: predicted peak {rec['predicted_peak']} not within "
          f"{DRYRUN_PEAK_RTOL:.0%} of the measured {peak}")
    return row


def dryrun_measure(fn, args_bytes: int) -> tuple[float, int, float, dict, object]:
    """One untimed run of ``fn`` under ``FlopCounterMode`` (its FLOPs, its
    peak: the arguments' bytes and what the run allocates above what was
    allocated before it, and the kernels' launches), then the median of 3
    runs timed by CUDA events."""
    from torch.utils.flop_counter import FlopCounterMode

    mods = kernel_modules()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = {n: m.launches for n, m in mods.items()}
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + args_bytes
    launches = {n: m.launches - before[n] for n, m in mods.items()}
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.inference_mode():
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return fc.get_total_flops(), peak, sorted(times)[1], {"launches": launches, "by_op": by_op}, out


def dryrun_serve_checks(engine, requests: list[dict], served: list[list[int]], tag: str) -> dict:
    """``[dryrun]``'s prefill and decode cells on the stablelm-3b slice's
    own weights: each predicted by ``run_cell`` on a (1, 1) mesh, then run
    for real through ``make_prefill``/``make_serve_step``. FLOPs equal,
    the peak within ``DRYRUN_PEAK_RTOL``, B1 32 a prefill through the
    custom op and 0 a decode step; and greedy tokens of the first batch
    through both step functions, at a 0-dim position tensor on the card,
    equal to what the engine served."""
    from repro_torch.serve.batcher import pad_prompts
    from repro_torch.serve.engine import make_prefill, make_serve_step

    cfg, params = engine.cfg, engine.params
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows, mods = {}, kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    p_name, p_seq, p_batch, _ = DRYRUN_CELLS[0]
    d_name, d_len, d_batch, _ = DRYRUN_CELLS[1]
    pred = {p_name: dryrun_predict(p_name, p_seq, p_batch, "prefill"),
            d_name: dryrun_predict(d_name, d_len, d_batch, "decode")}

    tokens = torch.randint(0, cfg.vocab_size, (p_batch, p_seq), generator=gen, device="cuda")
    prefill_fn = make_prefill(cfg)
    flops, peak, ms, info, _ = dryrun_measure(lambda: prefill_fn(params, {"tokens": tokens}),
                                              storage_bytes(params) + storage_bytes(tokens))
    check(flops == pred[p_name]["roofline"]["flops_per_device"],
          f"[dryrun] prefill FLOPs {flops} != the trace's {pred[p_name]['roofline']['flops_per_device']}")
    per_layer = 4 * p_batch * cfg.num_heads * cfg.head_dim * (p_seq * (p_seq + 1) // 2)
    check(info["launches"] == {"flash_attention": cfg.num_layers, "rwkv6_wkv": 0, "mamba_scan": 0}
          and info["by_op"].get("repro_torch.flash_attention") == cfg.num_layers * per_layer,
          f"[dryrun] prefill: launches {info['launches']}, the op's FLOPs "
          f"{info['by_op'].get('repro_torch.flash_attention')}: want B1 {cfg.num_layers} times "
          f"through repro_torch::flash_attention")
    rows[p_name] = dryrun_line(p_name, pred[p_name], flops, peak, ms, info["launches"])
    del tokens

    # decode: a real prefill of DRYRUN_DECODE_POS tokens grown to d_len, then one step
    ctx = torch.randint(0, cfg.vocab_size, (d_batch, DRYRUN_DECODE_POS), generator=gen, device="cuda")
    with torch.inference_mode():
        logits, cache = make_prefill(cfg, d_len)(params, {"tokens": ctx})
    tok = logits.argmax(-1)
    pos = torch.tensor(DRYRUN_DECODE_POS, dtype=torch.int32, device="cuda")
    step = make_serve_step(cfg)
    del logits, ctx
    flops, peak, ms, info, _ = dryrun_measure(
        lambda: step(params, tok, cache, pos),
        storage_bytes(params) + storage_bytes(cache) + storage_bytes(tok) + storage_bytes(pos))
    check(flops == pred[d_name]["roofline"]["flops_per_device"],
          f"[dryrun] decode FLOPs {flops} != the trace's {pred[d_name]['roofline']['flops_per_device']}")
    check(all(n == 0 for n in info["launches"].values()),
          f"[dryrun] decode step launched {info['launches']}, want none")
    rows[d_name] = dryrun_line(d_name, pred[d_name], flops, peak, ms, info["launches"])
    del cache

    # greedy tokens of the first batch, the position a 0-dim tensor on the card
    batch = torch.as_tensor(pad_prompts(requests[:4]), dtype=torch.long, device="cuda")
    with torch.inference_mode():
        logits, cache = make_prefill(cfg, engine.max_len)(params, {"tokens": batch})
        out = [logits[:, -1].argmax(-1, keepdim=True)]
        for i in range(NEW_TOKENS - 1):
            p = torch.tensor(batch.shape[1] + i, dtype=torch.int32, device="cuda")
            logits, cache = step(params, out[-1], cache, p)
            out.append(logits[:, -1].argmax(-1, keepdim=True))
    got = torch.cat(out, dim=1).tolist()
    check(got == served[:4], f"[dryrun] tokens through make_prefill/make_serve_step at a tensor "
                             f"position {got} differ from the served {served[:4]}")
    print(f"[dryrun] greedy tokens of the first batch through make_prefill/make_serve_step, the "
          f"position a 0-dim tensor on the card, equal the served ones: {got[0]}")
    return {"dryrun": rows, "launches": {n: m.launches for n, m in mods.items()}}


def phase_dryrun_train(train_stats: dict) -> dict:
    """``[dryrun]``'s train cell: ``run_cell`` of ``[train-full]``'s step
    (AdamW, remat "full", 2 microbatches) on a (1, 1) mesh, against the
    step time and peak ``[train-full]`` measured (no step of its own)."""
    from repro_torch.configs import TrainConfig

    name, seq, batch, _ = DRYRUN_CELLS[2]
    tcfg = TrainConfig(optimizer="adamw", learning_rate=1e-2, warmup_steps=0, total_steps=100,
                       microbatches=TRAIN_MICRO)
    rec = dryrun_predict(name, seq, batch, "train", tcfg)
    ms = sorted(train_stats["step_s"])[len(train_stats["step_s"]) // 2] * 1e3
    return dryrun_line(name, rec, None, train_stats["step_peak_bytes"], ms,
                       {"flash_attention": TRAIN_MICRO * 2 * 32})


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
    torch.cuda.synchronize()
    other_bytes = torch.cuda.memory_allocated() - storage_bytes(state)  # not the step's
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
             "step_peak_bytes": peak - other_bytes,
             "ce": [m["ce"] for m in losses], "grad_norm": [m["grad_norm"] for m in losses]}
    if kernels:
        busy_s = sum(r[2] for r in kernels) / 1e6
        b1_ms = sum(r[2] for r in kernels if "flash_fwd_" in r[0]) / 1e3
        b1_n = sum(r[1] for r in kernels if "flash_fwd_" in r[0])
        # the autograd engine's event for each backward of the B1 custom op
        # (the node's own event nests inside it: counting both doubles)
        recompute_ms = sum(e.device_time_total for e in events if e.key.startswith(
            "autograd::engine::evaluate_function: ") and B1_BACKWARD_NODE in e.key) / 1e3
        print(f"{tag} profiled step: wall {wall_s:.4f} s, device busy {busy_s:.4f} s, idle share "
              f"{1 - busy_s / wall_s:.4f} (profiler overhead included); B1 forward {b1_n}x "
              f"{b1_ms:.3f} ms; recomputation through the twin under the custom op's backward "
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


def _train_graph_run(cfg, tcfg, data, captured: bool, tag: str) -> dict:
    """``TRAIN_GRAPH_STEPS`` timed steps and one more of stablelm-3b full
    from the seed-0 state: eager (``make_train_step``), the last timed too,
    or captured (``TrainStep``), the last profiled (the eager step's
    profile is ``[train-full]``'s: processing a profile of an eager step's
    every op takes tens of seconds); each step's launches asserted.
    Returns the metrics and seconds of each step, the peaks, the profiled
    window, the parameters copied to the host and the state."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import init_params, model_spec
    from repro_torch.models.model import dtype_of
    from repro_torch.train.train_step import (
        WARMUP_STEPS, TrainStep, init_state, make_train_step, split_microbatches,
    )

    mods = kernel_modules()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_state(init_params(model_spec(cfg), gen, dtype_of(cfg.param_dtype), "cuda"), tcfg)
    if captured:
        run = TrainStep(cfg, tcfg, state)
    else:
        body = make_train_step(cfg, tcfg)

        def run(host: dict) -> dict:
            nonlocal state
            state, metrics = body(state, to_device(host, "cuda"))
            return metrics

    want = {name: cfg.num_layers * 2 * TRAIN_MICRO if name == "flash_attention" else 0
            for name in mods}  # forward + remat recomputation, per microbatch
    out = {"metrics": [], "step_s": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_GRAPH_STEPS + 1):
        host = split_microbatches(data.batch_at(i), TRAIN_MICRO)
        zero_launches(mods)
        capturing = captured and i == WARMUP_STEPS
        if capturing:
            torch.cuda.synchronize()
            out["peak_bytes"] = torch.cuda.max_memory_allocated()  # the warm-up's
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < TRAIN_GRAPH_STEPS or not captured:
            m = {k: float(v) for k, v in run(host).items()}
            out["step_s"].append(time.perf_counter() - t0)
        else:
            got = {}
            window = profile_window(lambda: got.update(run(host)), tag, "profiled replay")
            m = {k: float(v) for k, v in got.items()}
            if window is not None:
                out["profiled_wall_s"], out["profiled_busy_s"] = window
        if capturing:
            out["capture_peak_bytes"] = torch.cuda.max_memory_allocated()
            out["pool_bytes"] = torch.cuda.memory_reserved() - reserved
            out["reserved_bytes"] = torch.cuda.max_memory_reserved()
        out["metrics"].append(m)
        counts = {name: mod.launches for name, mod in mods.items()}
        check(counts == want, f"{tag} step {i}: kernel launches {counts}, want {want}")
        check(all(math.isfinite(v) for v in m.values()), f"{tag} step {i}: metrics {m}")
    if not captured:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["reserved_bytes"] = torch.cuda.max_memory_reserved()
    else:
        check(run.graph is not None, f"{tag}: no graph after {TRAIN_GRAPH_STEPS + 1} steps")
        run.close()
    out["state_bytes"] = storage_bytes(state)
    out["params"] = host_copy(state["params"])
    out["state"] = state
    return out


def phase_train_graph() -> dict:
    """``[train-graph]``, run by ``child_phase`` under ``CONTINUUM_ENV``:
    stablelm-3b full (``[train-full]``'s configuration and data), eager and
    then captured from the same seed under deterministic algorithms, held
    bit for bit; then ``TRAIN_GRAPH_EVALS`` eval batches through
    ``EvalStep`` against the eager ``make_eval_step``. Returns the launch
    counts and the stats."""
    import gc

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticTokens, to_device
    from repro_torch.train.train_step import WARMUP_STEPS, EvalStep, make_eval_step

    tag = "[train-graph]"
    mods = kernel_modules()
    cfg = get_config("stablelm-3b", "full")
    tcfg = TrainConfig(optimizer="adamw", learning_rate=1e-2, warmup_steps=0,
                       total_steps=100, microbatches=TRAIN_MICRO)
    data = SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for captured in (False, True):
            name = "captured" if captured else "eager"
            t0 = time.perf_counter()
            runs[name] = r = _train_graph_run(cfg, tcfg, data, captured, tag)
            later = sorted(r["step_s"][WARMUP_STEPS + 1:])  # replays, when captured
            steady = later[len(later) // 2]
            r["median_step_s"], r["tokens_per_s"] = steady, tokens / steady
            print(f"{tag} {name}: steps {[round(x, 4) for x in r['step_s']]} s; median of steps "
                  f"{WARMUP_STEPS + 1}-{len(r['step_s']) - 1} {steady:.4f} s, "
                  f"{tokens / steady:.1f} tokens/s; max_memory_allocated {r['peak_bytes']} "
                  f"bytes{' (the warm-up step)' if captured else ''}, state "
                  f"{r['state_bytes']}; max_memory_reserved {r['reserved_bytes']} bytes; run "
                  f"{time.perf_counter() - t0:.1f} s")
            if captured:
                r["capture_s"] = r["step_s"][WARMUP_STEPS] - steady
                print(f"{tag} captured: the capture (the call that captured, less a replay) "
                      f"{r['capture_s']:.4f} s; while capturing max_memory_allocated "
                      f"{r['capture_peak_bytes']} bytes; the graph's pool {r['pool_bytes']} "
                      f"bytes")
            else:  # two states do not fit the card
                del r["state"]
                gc.collect()
                torch.cuda.empty_cache()
        eager, graph = runs["eager"], runs["captured"]
        check(graph["metrics"] == eager["metrics"],
              f"{tag} metrics differ: captured {graph['metrics']}, eager {eager['metrics']}")
        same = [torch.equal(a, b) for a, b in zip(graph["params"], eager["params"], strict=True)]
        print(f"{tag} captured against eager over {TRAIN_GRAPH_STEPS + 1} steps: losses and grad "
              f"norms equal ({[m['loss'] for m in graph['metrics']]}); {sum(same)} of "
              f"{len(same)} parameter leaves bit-identical")
        check(all(same), f"{tag} {same.count(False)} parameter leaves differ")

        params = graph["state"]["params"]
        evals = SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=9999)
        body, step = make_eval_step(cfg, tcfg), EvalStep(cfg, tcfg, params)
        want_eval = {name: cfg.num_layers if name == "flash_attention" else 0 for name in mods}
        ev = {"eager": [], "captured": [], "eager_s": [], "captured_s": []}
        for i in range(TRAIN_GRAPH_EVALS):
            host = evals.batch_at(i)
            for name, fn in (("eager", lambda: body(params, to_device(host, "cuda"))),
                             ("captured", lambda: step(host))):
                zero_launches(mods)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev[name].append(float(fn()["ce"]))
                ev[f"{name}_s"].append(time.perf_counter() - t0)
                counts = {n: mod.launches for n, mod in mods.items()}
                check(counts == want_eval, f"{tag} eval {name} {i}: launches {counts}")
        check(step.graph is not None, f"{tag}: the eval step was not captured")
        step.close()
        print(f"{tag} eval over {TRAIN_GRAPH_EVALS} batches: ce {ev['captured']} (captured), "
              f"equal to eager: {ev['captured'] == ev['eager']}; s a batch eager "
              f"{[round(x, 4) for x in ev['eager_s']]}, captured "
              f"{[round(x, 4) for x in ev['captured_s']]}")
        check(ev["captured"] == ev["eager"], f"{tag} eval ce differs: {ev}")
    finally:
        torch.use_deterministic_algorithms(False)
    keys = ("step_s", "median_step_s", "tokens_per_s", "peak_bytes", "state_bytes",
            "reserved_bytes", "profiled_wall_s", "profiled_busy_s")
    stats = {name: {k: r[k] for k in keys if k in r} for name, r in runs.items()}
    stats["captured"].update({k: graph[k] for k in ("capture_s", "capture_peak_bytes",
                                                    "pool_bytes")})
    stats["eval"] = ev
    steps = 2 * (TRAIN_GRAPH_STEPS + 1)
    counts = {n: steps * cfg.num_layers * 2 * TRAIN_MICRO + 2 * TRAIN_GRAPH_EVALS * cfg.num_layers
              if n == "flash_attention" else 0 for n in mods}
    return {"counts": counts, "stats": stats}


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


def child_phase(flag: str, tag: str) -> dict:
    """The phase of ``CHILD_PHASES[flag]`` in a child process (``chip_smoke.py
    <flag>``) under ``CONTINUUM_ENV``; its output is passed on, and its last
    line, the phase's result as JSON, is returned."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag],
                         env=dict(os.environ, **CONTINUUM_ENV), capture_output=True, text=True,
                         timeout=600)
    lines = res.stdout.splitlines()
    for line in lines[:-1]:
        print(line)
    if res.returncode != 0:
        print(res.stderr[-8000:], file=sys.stderr)
    check(res.returncode == 0 and bool(lines), f"{tag} process exited {res.returncode}")
    print(f"{tag} {time.perf_counter() - t0:.1f} s in its own process")
    return json.loads(lines[-1])


def train_launches(cfg) -> dict[str, int]:
    """Each kernel of ``kernel_modules()``'s launches in one microbatch of
    a training step: a forward's (``prefill_launches``) and its remat
    recomputation's, and the MTP block's once (the reference does not
    rematerialise it)."""
    out = {name: 2 * n for name, n in prefill_launches(cfg).items()}
    if cfg.mtp_depth > 0:
        out["flash_attention"] += 1  # MLA
    return out


def phase_train_cross() -> dict:
    """Each of ``TRAIN_CROSS_CASES`` in float32: 3 steps on the card
    against the CPU from the same params and batches, for its optimizers
    at 1 and 2 microbatches; the kernels of its path (B1, B2, B3, each
    through its custom op and its gradient) launch on the card, the plain
    twins run on the CPU. Returns the card's launch counts and the largest
    differences, per arch."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticTokens, to_device
    from repro_torch.models import init_params, model_spec
    from repro_torch.train.train_step import (
        TrainStep, init_state, make_train_step, split_microbatches,
    )
    from repro_torch.tree import leaves_with_names, map_leaves

    mods = kernel_modules()
    reseeds = {"rwkv": reseed_rwkv, "jamba": reseed_jamba, "gates": reseed_gates}
    out, launches = {}, {}
    for arch, variant, optimizers, (atol, rtol), reseed in TRAIN_CROSS_CASES:
        tag = f"[train-cross] {arch} {variant}"
        cfg = get_config(arch, variant).copy(param_dtype="float32", compute_dtype="float32")
        params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32,
                             "cpu")
        if reseed is not None:
            reseeds[reseed](params, torch.Generator().manual_seed(4))
        data = SyntheticTokens(cfg, 4, 64, seed=1)
        worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0, "opt": 0.0}
        for optimizer in optimizers:
            for k in (1, 2):
                tcfg = TrainConfig(optimizer=optimizer, learning_rate=1e-3, warmup_steps=1,
                                   total_steps=10, microbatches=k)
                states = {dev: init_state(map_leaves(lambda p: p.to(dev, copy=True), params), tcfg)
                          for dev in ("cpu", "cuda")}
                body, captured = make_train_step(cfg, tcfg), TrainStep(cfg, tcfg, states["cuda"])
                for mod in mods.values():
                    mod.launches = 0
                for i in range(3):
                    host = data.batch_at(i)
                    if k > 1:
                        host = split_microbatches(host, k)
                    metrics = {"cuda": captured(host)}
                    states["cpu"], metrics["cpu"] = body(states["cpu"], to_device(host, "cpu"))
                    for key in metrics["cpu"]:
                        if key == "lr":
                            continue
                        a, b = float(metrics["cuda"][key]), float(metrics["cpu"][key])
                        err = abs(a - b)
                        check(err <= atol + rtol * abs(b),
                              f"{arch} {optimizer} k={k} step {i} {key}: cuda {a} cpu {b}")
                        if key in worst:
                            worst[key] = max(worst[key], err)
                counts = {name: mod.launches for name, mod in mods.items()}
                want = {name: 3 * k * n for name, n in train_launches(cfg).items()}
                check(counts == want, f"{arch} {optimizer} k={k}: launches {counts}, want {want}")
                check(captured.graph is not None, f"{arch} {optimizer} k={k}: not captured")
                launches[arch] = {n: launches.get(arch, {}).get(n, 0) + counts[n] for n in mods}
                for part in ("params", "opt"):
                    pairs = zip(leaves_with_names(states["cuda"][part]),
                                leaves_with_names(states["cpu"][part]))
                    for (name, a), (_, b) in pairs:
                        a = a.cpu()
                        err = (a - b).abs().max().item()
                        check(torch.allclose(a, b, atol=atol, rtol=rtol),
                              f"{arch} {optimizer} k={k} {name}: cuda vs cpu max_abs_err {err}")
                        worst[part] = max(worst[part], err)
                captured.close()
                print(f"{tag}: {optimizer}, {k} microbatch(es), 3 steps (captured on the card): loss "
                      f"{float(metrics['cuda']['loss']):.6f} (cpu "
                      f"{float(metrics['cpu']['loss']):.6f}); kernel launches on the card "
                      f"{counts}; worst so far {json.dumps(worst)}")
        print(f"{tag}: cuda vs cpu within atol {atol}, rtol {rtol}: largest differences "
              f"{json.dumps(worst)}")
        out[arch] = worst
    return launches, out


def reference_modules(modules) -> list[str]:
    """The names in ``modules`` (e.g. ``sys.modules``) of the reference
    package (``repro`` and ``repro.*``) and of JAX (any name starting with
    ``jax``), sorted: this process must hold none of them."""
    return sorted(n for n in modules if n == "repro" or n.startswith(("repro.", "jax")))


# Every broker process runs under the port's runtime detectors
# (``repro_torch.analysis``): the lock-order detector and the auth-fact
# contracts, switched on by its environment before the broker is built.
DETECTOR_ENV = {"REPRO_LOCK_CHECK": "1", "REPRO_AUTH_CHECK": "1"}
# What a broker process runs after registering the package: ``checked``
# wraps a server's ``handle`` to note each contract error a handler raised
# (and raise it on: the request fails), and ``report()`` is its answer to
# the harness's ``report``: whether each detector is on, the lock-order
# violations and contract errors since the process started, and per lock
# family the holds and the longest hold in ms since the last report
# (``holds``) and since the start (``holds_total``).
DETECTOR_SOURCE = """\
from repro_torch.analysis import authtrack, locktrack, statehash
from repro_torch.analysis.authtrack import AuthContractError
from repro_torch.analysis.contracts import LockContractError
contract_errors, holds_total = [], {}

def checked(handle):
    def wrapped(envelope, *args, **kwargs):
        try:
            return handle(envelope, *args, **kwargs)
        except (AuthContractError, LockContractError) as e:
            contract_errors.append(repr(e))
            raise
    return wrapped

def report(**extra):
    with locktrack._REG.guard:  # read and restart the hold window at once
        holds = {f: [st["count"], st["max_ns"] / 1e6] for f, st in locktrack._REG.holds.items()}
        locktrack._REG.holds.clear()
        violations = [dict(v) for v in locktrack._REG.violations]
    for f, (n, ms) in holds.items():
        tn, tms = holds_total.get(f, (0, 0.0))
        holds_total[f] = [tn + n, max(tms, ms)]
    return {"lock_check": locktrack.is_enabled(), "auth_check": authtrack.is_enabled(),
            "repl_check": statehash.is_enabled(), "violations": violations,
            "contract_errors": list(contract_errors), "holds": holds,
            "holds_total": dict(holds_total), **extra}
"""
REPORTS: list[dict] = []  # every broker process's reports, for [contracts]
# the lock families a broker process must have held by its last report:
# the memory database's, the sqlite file's (it has no shard or glock), and
# the replicated broker's (a MemoryDatabase behind Raft)
MEMORY_FAMILIES = ("shard", "glock", "queuecv")
SQLITE_FAMILIES = ("sqlite", "dbcolony", "queuecv")
HA_FAMILIES = MEMORY_FAMILIES + ("raft", "cluster", "applied")


def check_report(rep: dict, tag: str, families: tuple[str, ...]) -> dict:
    """Hold a broker process's ``report`` to the detectors' contract: both
    detectors on, no lock-order violation, no contract error, no error in
    the failsafe loop (which would swallow one), and each of ``families``
    held at least once since the process started."""
    REPORTS.append(dict(rep, tag=tag))
    holds = ", ".join(f"{f} {n} ({ms:.3f} ms)" for f, (n, ms) in sorted(rep["holds"].items()))
    print(f"{tag} detectors: lock {rep['lock_check']}, auth {rep['auth_check']}, replication "
          f"{rep['repl_check']}; {len(rep['violations'])} lock-order violations, "
          f"{len(rep['contract_errors'])} contract errors; holds since the last report "
          f"(longest): {holds}")
    check(rep["lock_check"] and rep["auth_check"], f"{tag} a detector is off: {rep}")
    check(not rep["violations"], f"{tag} lock-order violations {rep['violations']}")
    check(not rep["contract_errors"], f"{tag} contract errors {rep['contract_errors']}")
    check(rep["failsafe_errors"] == 0, f"{tag} failsafe errors {rep['failsafe_errors']}")
    unused = [f for f in families if rep["holds_total"].get(f, (0,))[0] == 0]
    check(not unused, f"{tag} families never held in this broker process: {unused}")
    return rep


# The broker process. ColonyOS deploys the broker as a service of its own,
# which executors on any platform reach only through the signed JSON
# protocol over HTTP; so it runs here as a separate process, and this
# process reaches it only through the port's HttpTransport. The broker is
# the port's stdlib copy, ``repro_torch.broker``, which uses torch for
# nothing: the child registers the ``repro_torch`` package by its path
# without running its ``__init__`` (which warms torch's CPU ``exp``), so it
# loads neither torch nor any module of the reference. Its arguments: the
# server id, the package's path, the database (``memory``, the indexed
# ``MemoryDatabase``, or the path of a ``SqliteDatabase`` file, opened
# as it is) and the port (0: a free one). It verifies every signature
# (and shows that it refuses an unsigned request), runs the failsafe
# scanner and the generators' ticks every 0.1 s, prints its port, then
# what it imported and the seconds it took to open the database. It runs
# under the port's detectors (``DETECTOR_ENV``, ``DETECTOR_SOURCE``) and
# answers ``report`` on stdin with one JSON line until it is killed.
BROKER_SOURCE = """\
import json, sys, threading, time, types
t0 = time.perf_counter()
pkg = types.ModuleType("repro_torch")
pkg.__path__ = [sys.argv[2]]
sys.modules["repro_torch"] = pkg
""" + DETECTOR_SOURCE + """\
from repro_torch.broker import (ColoniesHttpServer, MemoryDatabase, SqliteDatabase,
                                standalone_server)
t_open = time.perf_counter()
db = MemoryDatabase() if sys.argv[3] == "memory" else SqliteDatabase(sys.argv[3])
open_s = time.perf_counter() - t_open
srv = standalone_server(sys.argv[1], db)
srv.handle = checked(srv.handle)
http = ColoniesHttpServer(srv, port=int(sys.argv[4]))
http.start()
srv.start_background(failsafe_interval=0.1)
print(http.port, flush=True)
tops = {n.split(".")[0] for n in sys.modules}
unsigned = srv.handle({"payloadtype": "colonystats", "payload": "{}", "identity": sys.argv[1]})
print(json.dumps({"refuses_unsigned": unsigned.get("status") == 403,
                  "start_s": time.perf_counter() - t0, "db": type(db).__name__,
                  "open_s": open_s,
                  "torch_or_jax": sorted(tops & {"torch", "jax", "jaxlib"}),
                  "reference": sorted(tops & {"repro"})}), flush=True)
for line in sys.stdin:
    if line.split() == ["report"]:
        out = report(failsafe_errors=srv.failsafe_errors)
    else:
        out = {"error": f"unknown command {line.strip()!r}"}
    print(json.dumps(out), flush=True)
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
    """The broker process (``BROKER_SOURCE``) over ``db`` (``"memory"`` or a
    sqlite file's path) and the port's signed HTTP client to it, with a
    server key and a colony key of this run. ``kill()`` ends the process
    with SIGKILL; ``restart()`` starts a new one on the same port over the
    same database. ``retry`` is the client transport's ``RetryPolicy``
    (None: a lost connection surfaces at once)."""

    def __init__(self, db: str = "memory", retry=None) -> None:
        from repro_torch.core.client import Colonies
        from repro_torch.core.crypto import Crypto
        from repro_torch.core.http_transport import HttpTransport

        self.server_prv, self.colony_prv = Crypto.prvkey(), Crypto.prvkey()
        self.db, self.port, self.proc, self.killed_at = db, 0, None, None
        self._start()
        self.transport = HttpTransport("127.0.0.1", self.port, retry=retry)
        self.client = Colonies(self.transport)

    def _start(self) -> None:
        from repro_torch.core.crypto import Crypto

        t0 = time.perf_counter()
        root = Path(__file__).resolve().parent
        self.proc = subprocess.Popen(
            [sys.executable, "-c", BROKER_SOURCE, Crypto.id(self.server_prv),
             str(root / "src" / "repro_torch"), self.db, str(self.port)],
            cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, **DETECTOR_ENV))
        try:
            port = self.proc.stdout.readline().strip()
            self.up_at = time.perf_counter()
            info = self.proc.stdout.readline().strip()
            self.start_s = time.perf_counter() - t0
            check(port.isdigit() and bool(info), f"the broker process printed {port!r}, {info!r}")
            check(self.port in (0, int(port)), f"the broker came back on {port}, not {self.port}")
            self.port, self.info = int(port), json.loads(info)
        except BaseException:
            self.close()
            raise

    def report(self, tag: str, families: tuple[str, ...] = ()) -> dict:
        """The process's detector report, held by ``check_report``."""
        check(self.alive(), f"{tag} the broker process died before its report")
        self.proc.stdin.write("report\n")
        self.proc.stdin.flush()
        return check_report(json.loads(self.proc.stdout.readline()), tag, families)

    def kill(self, tag: str, families: tuple[str, ...]) -> None:
        """SIGKILL, no terminate: the process gets no chance to flush. Its
        detector report is read first."""
        self.report(tag, families)
        self.killed_at = time.perf_counter()
        self.proc.kill()
        self.proc.wait(timeout=10)
        for pipe in (self.proc.stdin, self.proc.stdout):
            pipe.close()

    def restart(self) -> float:
        """A new process on the same port over the same database; returns
        the seconds from the kill to its printed port."""
        self._start()
        return self.up_at - self.killed_at

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
        for pipe in (self.proc.stdin, self.proc.stdout):
            if not pipe.closed:
                pipe.close()


def signed_stats(broker: Broker, n: int) -> tuple[dict, list[float]]:
    """``n`` signed colonystats of the colony: the last reply and each
    round trip's seconds."""
    seconds = []
    for _ in range(n):
        t0 = time.perf_counter()
        stats = broker.client.stats(COLONY, broker.colony_prv)
        seconds.append(time.perf_counter() - t0)
    return stats, seconds


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
    stats, seconds = signed_stats(broker, 20)
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
        before = trace.snapshot()["counters"]
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
        check(served_since(before)["batches"] == 1,
              f"hand-off batches {served_since(before)}")
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


def hold_to_eager(engine, packed: list[dict], served: list[list[int]], tag: str) -> None:
    """A served batch's tokens against an eager ``decode_step`` loop on the
    engine's own weights; the engine captured one graph for its key."""
    from repro_torch.serve.batcher import pad_prompts

    tokens = torch.as_tensor(pad_prompts(packed), dtype=torch.long, device=engine.device)
    eager = eager_decode(engine, {"tokens": tokens}, len(served[0]))[0]
    check(served == eager, "the served batch's tokens differ from the eager decode loop's")
    engine_step(engine, len(packed), tag)
    print(f"{tag} the first batch's served tokens equal an eager decode_step loop's")


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
    before = trace.snapshot()["counters"]
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
          f"{[len(q['spec']['kwargs']['packed_args']) for q in batches]}; served "
          f"{served_since(before)}; launches {counts} (want {want})")
    sizes = [len(q["spec"]["kwargs"]["packed_args"]) for q in batches]
    served = served_since(before)
    check(sizes == [4, 4] and served["batches"] == 2 and served["requests"] == 8,
          f"batches of {sizes}, served {served}")
    check(counts == want, f"launches {counts}, want {want}")
    prefill_s = []
    for i, q in enumerate(batches):
        packed = q["spec"]["kwargs"]["packed_args"]
        direct = engine.generate(pad_prompts(packed), max_new_tokens=NEW_TOKENS).tolist()
        got = [served[r["request_id"]] for r in packed]
        check(got == direct, "served tokens differ from the engine's own generate on the batch")
        if i == 0:
            hold_to_eager(engine, packed, got, tag)
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


# [durable-*]: the broker over a SqliteDatabase file, SIGKILLed and started
# again over it. The file holds the 10k processes of
# benchmarks/bench_broker.py's colonystats and failsafe probes: 9,000
# closed, 800 waiting for an executor type nobody runs, 200 waiting for an
# executor name nobody has (of the trainers' type, so every assign walks
# past them). It lives in the git-ignored build/.
DURABLE_DB = Path(__file__).resolve().parent / "build" / "durable" / "colonies.db"
DURABLE_CLOSED = {"successful": 8_100, "failed": 900}
DURABLE_WAITING = {"type nobody runs": 800, "name nobody has": 200}
# The clients of a broker that restarts retry a lost connection for up to
# 30 s, every 0.05-0.5 s. RetryPolicy's default (8 attempts) gives up
# after its 7 backoffs, which decorrelated jitter can draw all near the
# 0.02-s base: under a second in all, shorter than a restart may take.
DURABLE_RETRY_KW = dict(base_s=0.05, cap_s=0.5, deadline_s=30.0, budget=64, seed=5)


def durable_file() -> tuple[dict, float]:
    """Writes the processes of colony ``h100`` into ``DURABLE_DB`` through
    the port's ``SqliteDatabase`` (``add_process``, then ``update_process``
    for the closed ones); returns the per-state counts written and the
    seconds it took."""
    from repro_torch.broker import SqliteDatabase
    from repro_torch.core.process import Process, now_ns
    from repro_torch.core.spec import FunctionSpec

    DURABLE_DB.parent.mkdir(parents=True, exist_ok=True)
    for suffix in ("", "-wal", "-shm"):
        Path(str(DURABLE_DB) + suffix).unlink(missing_ok=True)
    t0 = time.perf_counter()
    db = SqliteDatabase(str(DURABLE_DB))

    def spec(etype: str, names: list[str] | None = None) -> FunctionSpec:
        return FunctionSpec.from_dict({
            "conditions": {"colonyname": COLONY, "executortype": etype,
                           "executornames": names or []},
            "funcname": "archive", "args": ["x" * 64], "maxexectime": 600})

    closed = [state for state, n in DURABLE_CLOSED.items() for _ in range(n)]
    for state in closed:
        p = Process.create(spec("h100-pod"))
        db.add_process(p)
        p.state, p.endtime_ns = state, now_ns()
        db.update_process(p)
    for _ in range(DURABLE_WAITING["type nobody runs"]):
        db.add_process(Process.create(spec("cpu-archive")))
    for _ in range(DURABLE_WAITING["name nobody has"]):
        db.add_process(Process.create(spec("h100-pod", ["h100-offline"])))
    want = dict(DURABLE_CLOSED, waiting=sum(DURABLE_WAITING.values()))
    check(db.colony_stats(COLONY) == want, f"the file's counts {db.colony_stats(COLONY)}")
    del db  # its connection closes with it
    return want, time.perf_counter() - t0


def phase_durable_broker(broker: Broker, want: dict, written_s: float, alone: dict) -> dict:
    """The broker process over the 10k-process file: what it imported, the
    seconds it took to open the file; the colony, and 20 signed colonystats
    with the counts written; then SIGKILL, a restart over the file, and the
    same counts from the new process."""
    from repro_torch.core.crypto import Crypto

    tag = "[durable-broker]"
    n = sum(want.values())
    print(f"{tag} {n} processes written to {DURABLE_DB.name} through SqliteDatabase in "
          f"{written_s:.3f} s ({DURABLE_DB.stat().st_size} bytes, and the WAL's)")
    print(f"{tag} broker process {broker.proc.pid} on port {broker.port}: {json.dumps(broker.info)}; "
          f"up after {broker.start_s:.3f} s")
    check(broker.info["db"] == "SqliteDatabase", f"the broker opened {broker.info['db']}")
    check(broker.info["refuses_unsigned"] is True, "the broker took an unsigned request")
    check(broker.info["torch_or_jax"] == [] and broker.info["reference"] == [],
          f"the broker process imported {broker.info['torch_or_jax'] + broker.info['reference']}")

    def counts(stats: dict) -> dict:
        return {k: stats[k] for k in want} | {"running": stats["running"]}

    broker.client.add_colony(COLONY, Crypto.id(broker.colony_prv), broker.server_prv)
    stats, seconds = signed_stats(broker, 20)
    check(counts(stats) == dict(want, running=0), f"colonystats {stats}, written {want}")
    rtt = sum(seconds) / len(seconds)
    open_s = broker.info["open_s"]
    broker.kill(tag, ("sqlite",))  # this process served colonystats only
    restart_s = broker.restart()
    check(broker.info["torch_or_jax"] == [] and broker.info["reference"] == [],
          f"the restarted broker imported {broker.info['torch_or_jax'] + broker.info['reference']}")
    after, seconds_after = signed_stats(broker, 20)
    check(counts(after) == counts(stats), f"colonystats after the restart {after}, before {stats}")
    rtt_after = sum(seconds_after) / len(seconds_after)
    print(f"{tag} 20 signed colonystats: {counts(stats)}; mean round trip {rtt * 1e3:.3f} ms (min "
          f"{min(seconds) * 1e3:.3f}, max {max(seconds) * 1e3:.3f}), [broker]'s over an empty "
          f"MemoryDatabase {alone['rpc_mean_s'] * 1e3:.3f} ms in this run; the file opened in "
          f"{open_s * 1e3:.3f} ms")
    print(f"{tag} SIGKILL and restart: port {broker.port} again after {restart_s:.3f} s from the "
          f"kill (the file opened in {broker.info['open_s'] * 1e3:.3f} ms); the same counts; mean "
          f"round trip {rtt_after * 1e3:.3f} ms")
    return {"written_s": written_s, "processes": n, "open_s": open_s, "start_s": broker.start_s,
            "rpc_mean_s": rtt, "rpc_min_s": min(seconds), "rpc_max_s": max(seconds),
            "restart_s": restart_s, "reopen_s": broker.info["open_s"],
            "rpc_mean_after_restart_s": rtt_after}


def phase_durable_continuum(broker: Broker) -> tuple[dict, dict]:
    """``[executors-continuum]``'s hand-off over the 10k-process file: run
    "durable" trains 4 steps with 4 checkpoints while the broker is
    SIGKILLed and restarted once its first checkpoint is listed; train
    closes successful once, with 0 retries. A ServeExecutor restores the
    run from CFS and serves 4 requests through a generator of queuesize 4;
    the broker is killed and restarted again after the 2nd pack's reply
    and before the 3rd pack: the generator fires once, with 4 packs, and
    the tokens equal the engine's own generate."""
    from repro_torch.configs import get_config
    from repro_torch.core.fs import CFSClient, MemoryStorage
    from repro_torch.core.spec import FunctionSpec
    from repro_torch.runtime import torch_executor as tx
    from repro_torch.serve.batcher import InferenceClient, pad_prompts

    tag = "[durable-continuum]"
    t_phase = time.perf_counter()
    mods = kernel_modules()
    layers = get_config("stablelm-3b", "smoke").num_layers
    client, prv = broker.client, broker.colony_prv
    storage = MemoryStorage()
    kw = dict(colony_prvkey=prv, device="cuda")
    running, restart_s = [], []

    def start(ex):
        running.append(ex)
        ex.start(poll_timeout=0.2)
        return ex

    try:
        zero_launches(mods)
        trainer = start(tx.TrainerExecutor(client, COLONY, "h100-durable", "h100-pod", storage,
                                           **kw))
        p = client.submit(FunctionSpec.from_dict({
            "conditions": {"colonyname": COLONY, "executortype": "h100-pod"},
            "funcname": "train", "kwargs": dict(EXEC_TRAIN_KW, run="durable"),
            "maxexectime": 600}), prv)
        t0 = time.perf_counter()
        while not any(f["name"] == "latest.json"
                      for f in client.get_files(COLONY, "/checkpoints/durable", prv)):
            check(time.perf_counter() - t0 < 600, "no checkpoint of run durable was listed")
            time.sleep(0.05)
        before = client.get_process(p["processid"], prv)
        broker.kill(tag, SQLITE_FAMILIES)
        restart_s.append(broker.restart())
        after = client.get_process(p["processid"], prv)
        print(f"{tag} the first checkpoint listed {time.perf_counter() - t0:.3f} s after the "
              f"submit; SIGKILL and restart in {restart_s[0]:.3f} s; train is {after['state']} "
              f"on {after['assignedexecutorid'][:8]} with its deadline "
              f"{'kept' if after['deadline'] == before['deadline'] else 'changed'}")
        check(after["state"] == "running" and after["deadline"] == before["deadline"] > 0
              and after["assignedexecutorid"] == before["assignedexecutorid"],
              f"train after the restart: {after['state']}, deadline {after['deadline']} "
              f"(before {before['deadline']})")
        done = client.wait(p["processid"], prv, timeout=600)
        trainer.stop()
        print(f"{tag} train (4 steps, 4 checkpoints): {done['state']}, retries {done['retries']}, "
              f"{done['out'] or done['errors']}; the trainer processed {trainer.processed}, "
              f"failed {trainer.failed}")
        check(done["state"] == "successful" and done["retries"] == 0
              and done["out"][0]["final_step"] == 3 and trainer.processed == 1
              and trainer.failed == 0, f"train: {done['state']} {done['errors'] or done['out']}")
        before = trace.snapshot()["counters"]
        server = start(tx.ServeExecutor(client, COLONY, "h100-serve-durable", "h100-serve",
                                        storage, arch="stablelm-3b", max_len=64, run="durable",
                                        **kw))
        g = client.add_generator({"colonyname": COLONY, "name": "durable-gen", "queuesize": 4,
                                  "timeout": 30.0, "workflow": serve_workflow()}, prv)
        infc = InferenceClient(client, CFSClient(client, storage, prv), COLONY, g["generatorid"],
                               prv)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 256, n).tolist() for n in (5, 12, 9, 16)]
        rids = [infc.submit(pr, max_new_tokens=8) for pr in prompts[:2]]
        broker.kill(tag, SQLITE_FAMILIES)  # two packs stored, their replies in hand: none in flight
        restart_s.append(broker.restart())
        rids += [infc.submit(pr, max_new_tokens=8) for pr in prompts[2:]]
        served = [infc.wait(r, timeout=120) for r in rids]
        server.stop()
        launches = {name: mod.launches for name, mod in mods.items()}
        gen = [e for e in client.get_generators(COLONY, prv)
               if e["generatorid"] == g["generatorid"]][0]
        print(f"{tag} SIGKILL and restart between the 2nd and the 3rd pack in {restart_s[1]:.3f} "
              f"s; the generator ran {gen['runs']} time(s), {gen['pending']} pending; served "
              f"{served_since(before)}")
        counted = served_since(before)
        check(gen["runs"] == 1 and gen["pending"] == 0 and counted["batches"] == 1
              and counted["requests"] == 4 and server.processed == 1,
              f"generator {gen}, served {counted}, processed {server.processed}")
        direct = server.engine.generate(pad_prompts([{"prompt": pr} for pr in prompts]),
                                        max_new_tokens=8).tolist()
        print(f"{tag} served from the restored checkpoint: {served[0]} ...; identical to the "
              f"engine's own generate: {served == direct}")
        check(served == direct, "tokens served through the generator differ from generate's")
        want = {name: EXEC_TRAIN_KW["steps"] * 2 * layers + layers
                if name == "flash_attention" else 0 for name in mods}
        print(f"{tag} launches {launches} (want {want}, [executors-continuum]'s hand-off)")
        check(launches == want, f"launches {launches}, want {want}")
        check(broker.alive(), "the broker process died")
    finally:
        for ex in running:
            ex.stop()
    seconds = time.perf_counter() - t_phase
    print(f"{tag} {seconds:.1f} s")
    return launches, {"restart_s": restart_s, "train_attempt_s":
                      (done["endtime"] - done["starttime"]) / 1e9, "seconds": seconds}


def phase_durable_serve_full(broker: Broker, alone: dict) -> tuple[dict, dict]:
    """``[executors-serve-full]`` behind the file's broker: full-width
    stablelm-3b (float32) in a ServeExecutor behind a generator of
    queuesize 4, 8 signed requests over HTTP in 2 batches, the broker
    SIGKILLed and restarted between them; tokens equal to the engine's own
    generate on each batch, 32 flash attention launches a prefill."""
    from repro_torch.core.fs import CFSClient, MemoryStorage
    from repro_torch.launch.serve import make_requests
    from repro_torch.runtime import torch_executor as tx
    from repro_torch.serve.batcher import InferenceClient, pad_prompts

    tag = "[durable-serve-full]"
    t_phase = time.perf_counter()
    mods = kernel_modules()
    client, prv = broker.client, broker.colony_prv
    storage = MemoryStorage()
    ex = tx.ServeExecutor(client, COLONY, "h100-serve-durable-full", "h100-serve", storage,
                          colony_prvkey=prv, arch="stablelm-3b", variant="full",
                          max_len=max(PROMPT_LENS) + NEW_TOKENS, device="cuda")
    engine, cfg = ex.engine, ex.engine.cfg
    check(cfg.num_layers == 32 and cfg.param_dtype == "float32",
          f"{cfg.num_layers} layers, {cfg.param_dtype}")
    before = trace.snapshot()["counters"]
    try:
        ex.start(poll_timeout=0.2)
        g = client.add_generator({"colonyname": COLONY, "name": "durable-serve-full",
                                  "queuesize": 4, "timeout": 60.0,
                                  "workflow": serve_workflow()}, prv)
        infc = InferenceClient(client, CFSClient(client, storage, prv), COLONY, g["generatorid"],
                               prv)
        requests = make_requests(PROMPT_LENS, cfg.vocab_size, NEW_TOKENS, seed=1)
        batches = [requests[:4], requests[4:]]
        zero_launches(mods)
        t0 = time.perf_counter()
        served, batch_s = [], []
        for i, batch in enumerate(batches):
            if i:
                broker.kill(tag, SQLITE_FAMILIES)
                restart_s = broker.restart()
            t = time.perf_counter()
            rids = [infc.submit(r["prompt"], max_new_tokens=NEW_TOKENS) for r in batch]
            served.append([infc.wait(rid, timeout=600) for rid in rids])
            batch_s.append(time.perf_counter() - t)
        wall_s = time.perf_counter() - t0
        counts = {name: mod.launches for name, mod in mods.items()}
        check(broker.alive(), "the broker process died")
    finally:
        ex.stop()
    want = {name: 32 * 2 if name == "flash_attention" else 0 for name in mods}
    print(f"{tag} 8 requests in 2 batches, SIGKILL and restart between them in {restart_s:.3f} "
          f"s; served {served_since(before)}; launches {counts} (want {want})")
    served = served_since(before)
    check(served["batches"] == 2 and served["requests"] == 8 and ex.processed == 2,
          f"served {served}, processed {ex.processed}")
    check(counts == want, f"launches {counts}, want {want}")
    for batch, got in zip(batches, served):
        direct = engine.generate(pad_prompts(batch), max_new_tokens=NEW_TOKENS).tolist()
        check(got == direct, "served tokens differ from the engine's own generate on the batch")
    n_tok = len(requests) * NEW_TOKENS
    stats = {"wall_s": wall_s, "tokens_per_s": n_tok / wall_s, "batch_s": batch_s,
             "restart_s": restart_s}
    print(f"{tag} served tokens identical to generate on each batch; first submit to last "
          f"result {wall_s:.3f} s, {n_tok / wall_s:.1f} tokens/s, the restart included (alone, "
          f"[executors-serve-full]: {alone['wall_s']:.3f} s, {alone['tokens_per_s']:.1f}); each "
          f"batch from its first submit to its last result {[round(x, 3) for x in batch_s]} s")
    del ex, engine
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} {stats['seconds']:.1f} s")
    return counts, stats


# The replicated broker process: the port's HAColonyCluster (three replicas
# over one shared database, Raft electing the leader that serves assign and
# close), one ColoniesHttpServer per replica, the digest check armed
# (``statehash.enable``). Like BROKER_SOURCE it loads neither torch nor the
# reference. It prints the three ports, then what it imported and the
# leader; then it takes harness commands, one per stdin line, and answers
# each with one JSON line: ``leader``; ``kill i`` (partition replica i away:
# its HTTP server keeps answering, its Raft node hears nothing) and
# ``revive i``; ``stats`` (terms, commit and applied indexes, the first
# replication divergence, threads, replicas alive, and the last kill's
# failover: seconds to a new leader and to the first assign a replica other
# than the killed one served); ``report`` (the detectors' report, as
# BROKER_SOURCE's). No leader within 10 s exits 3.
HA_BROKER_SOURCE = """\
import json, sys, threading, time, types
t0 = time.perf_counter()
pkg = types.ModuleType("repro_torch")
pkg.__path__ = [sys.argv[2]]
sys.modules["repro_torch"] = pkg
""" + DETECTOR_SOURCE + """\
from repro_torch.broker import ColoniesHttpServer, HAColonyCluster
statehash.enable(True)
cluster = HAColonyCluster(sys.argv[1], replicas=3, seed=int(sys.argv[3]))
for srv in cluster.servers:
    srv.handle = checked(srv.handle)
https = [ColoniesHttpServer(s) for s in cluster.servers]
assigns = [[] for _ in cluster.servers]  # time.monotonic() of each assign served

def counted(i, assign):
    def wrapped(colony, ex, timeout):
        p = assign(colony, ex, timeout)
        if p is not None:
            assigns[i].append(time.monotonic())
        return p
    return wrapped

for i, srv in enumerate(cluster.servers):
    srv.assign = counted(i, srv.assign)
for h in https:
    h.start()
cluster.start(failsafe_interval=0.1)
leader = cluster.wait_for_leader(10)
if leader is None:
    print(json.dumps({"error": "no leader within 10 s"}), flush=True)
    sys.exit(3)
print(json.dumps([h.port for h in https]), flush=True)
tops = {n.split(".")[0] for n in sys.modules}
unsigned = cluster.servers[0].handle({"payloadtype": "colonystats", "payload": "{}",
                                      "identity": sys.argv[1]})
print(json.dumps({"refuses_unsigned": unsigned.get("status") == 403,
                  "start_s": time.perf_counter() - t0, "leader": leader,
                  "torch_or_jax": sorted(tops & {"torch", "jax", "jaxlib"}),
                  "reference": sorted(tops & {"repro"})}), flush=True)
kill = {}

def watch(nid, t_kill):
    while cluster.raft.leader_id() in (None, nid):
        time.sleep(0.002)
    kill["elected_s"] = time.monotonic() - t_kill

def failover():
    if not kill:
        return None
    others = [t for i, ts in enumerate(assigns) if i != kill["index"] for t in ts
              if t > kill["t"]]
    return {"killed": kill["index"], "elected_s": kill.get("elected_s"),
            "first_assign_s": min(others) - kill["t"] if others else None}

for line in sys.stdin:
    cmd = line.split()
    try:
        if cmd[0] == "leader":
            out = {"leader": cluster.raft.leader_id()}
        elif cmd[0] == "kill":
            i = int(cmd[1])
            kill.clear()
            kill.update(index=i, t=time.monotonic())
            cluster.kill_server(i)
            threading.Thread(target=watch, args=(f"n{i}", kill["t"]), daemon=True).start()
            out = {"killed": i}
        elif cmd[0] == "revive":
            cluster.revive_server(int(cmd[1]))
            out = {"revived": int(cmd[1])}
        elif cmd[0] == "stats":
            nodes = cluster.raft.nodes
            journal = cluster.raft.journal
            out = {"leader": cluster.raft.leader_id(),
                   "terms": {n: v.current_term for n, v in nodes.items()},
                   "commit": {n: v.commit_index for n, v in nodes.items()},
                   "applied": {n: v.last_applied for n, v in nodes.items()},
                   "divergence": None if journal is None or journal.divergence is None
                   else str(journal.divergence),
                   "journaled": None if journal is None else
                   {n: len(journal.entries(n)) for n in journal.nodes()},
                   "assigns": [len(ts) for ts in assigns], "failover": failover(),
                   "failsafe_errors": [s.failsafe_errors for s in cluster.servers],
                   "replicas_alive": [h._thread.is_alive() and s._failsafe_thread.is_alive()
                                      for h, s in zip(https, cluster.servers)],
                   "threads": threading.active_count()}
        elif cmd[0] == "report":
            out = report(failsafe_errors=sum(s.failsafe_errors for s in cluster.servers))
        else:
            out = {"error": f"unknown command {line.strip()!r}"}
    except Exception as e:
        out = {"error": repr(e)}
    print(json.dumps(out), flush=True)
"""
HA_SEED = 7
# The HA clients' retry: during an election every replica answers 421 for
# up to a second or two, and a call on the partitioned leader waits for
# its step-down; the clients ride that out (tests/test_chaos_soak.py's)
HA_RETRY_KW = dict(base_s=0.01, cap_s=0.3, deadline_s=20.0, budget=64, seed=3)
HA_BACKLOG = 200  # echo processes the chaos-killed CPU workers drain


def failover_allowance_s() -> int:
    """What a failover can add to a healthy attempt's close: the partitioned
    leader's step-down (check-quorum, 2 x the election timeout's upper end)
    and, at worst, the Raft commit timeout of a close proposed there."""
    from repro_torch.broker import raft

    return math.ceil(2 * raft.ELECTION_TIMEOUT_MS[1] / 1000 + raft.COMMIT_TIMEOUT_S)


class HABroker:
    """The replicated broker process (``HA_BROKER_SOURCE``), its harness
    commands, and the port's signed HTTP client over its three replicas."""

    def __init__(self) -> None:
        from repro_torch.core.client import Colonies
        from repro_torch.core.crypto import Crypto

        self.server_prv, self.colony_prv = Crypto.prvkey(), Crypto.prvkey()
        t0 = time.perf_counter()
        root = Path(__file__).resolve().parent
        self.proc = subprocess.Popen(
            [sys.executable, "-c", HA_BROKER_SOURCE, Crypto.id(self.server_prv),
             str(root / "src" / "repro_torch"), str(HA_SEED)], cwd=root, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, env=dict(os.environ, **DETECTOR_ENV))
        try:
            ports = self.proc.stdout.readline().strip()
            info = self.proc.stdout.readline().strip()
            self.start_s = time.perf_counter() - t0
            check(ports.startswith("[") and bool(info),
                  f"the replicated broker process printed {ports!r}, {info!r}")
            self.ports = json.loads(ports)
            self.info = json.loads(info)
        except BaseException:
            self.close()
            raise
        self.client = Colonies(self.transport())

    def transport(self, ports: list[int] | None = None):
        """A new HttpTransport over ``ports`` (all three by default), with
        the HA retry policy: one per actor, like a socket of its own."""
        from repro_torch.core.http_transport import HttpTransport
        from repro_torch.core.retry import RetryPolicy

        ports = ports or self.ports
        return HttpTransport("127.0.0.1", ports[0], fallbacks=[("127.0.0.1", p) for p in ports[1:]],
                             retry=RetryPolicy(**HA_RETRY_KW))

    def command(self, cmd: str) -> dict:
        check(self.alive(), f"the replicated broker process died before {cmd!r}")
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        out = json.loads(self.proc.stdout.readline())
        check("error" not in out, f"broker harness {cmd!r}: {out}")
        return out

    def leader(self, timeout: float = 10.0) -> int:
        """The leader replica's index, once there is one (an election may
        be under way): no leader within ``timeout`` fails the run."""
        deadline = time.perf_counter() + timeout
        while (lid := self.command("leader")["leader"]) is None:
            check(time.perf_counter() < deadline, f"no leader within {timeout} s")
            time.sleep(0.02)
        return int(lid[1:])

    def report(self, tag: str, families: tuple[str, ...] = ()) -> dict:
        """The process's detector report, held by ``check_report``."""
        return check_report(self.command("report"), tag, families)

    def stats(self) -> dict:
        st = self.command("stats")
        check(st["divergence"] is None, f"replication diverged: {st['divergence']}")
        check(all(st["replicas_alive"]), f"a replica's server or failsafe died: {st}")
        check(not any(st["failsafe_errors"]), f"failsafe errors {st['failsafe_errors']}")
        return st

    def alive(self) -> bool:
        return self.proc.poll() is None

    def close(self) -> None:
        if self.alive():
            self.proc.stdin.close()
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self.proc.stdout.close()


def phase_ha_broker(ha: HABroker) -> dict:
    """The replicated broker is up with a leader, verifies signatures and
    imported neither torch nor jax; the colony is created; 20 signed
    ``colonystats`` calls to each replica give the mean round trip."""
    from repro_torch.core.client import Colonies
    from repro_torch.core.crypto import Crypto

    tag = "[ha-broker]"
    print(f"{tag} replicated broker process {ha.proc.pid} on ports {ha.ports}: "
          f"{json.dumps(ha.info)}; up after {ha.start_s:.3f} s")
    check(ha.info["refuses_unsigned"] is True, "the replicated broker took an unsigned request")
    check(ha.info["torch_or_jax"] == [] and ha.info["reference"] == [],
          f"the replicated broker imported {ha.info['torch_or_jax'] + ha.info['reference']}")
    ha.client.add_colony(COLONY, Crypto.id(ha.colony_prv), ha.server_prv)
    rtt = {}
    for i, port in enumerate(ha.ports):
        client = Colonies(ha.transport([port]))
        seconds = []
        for _ in range(20):
            t0 = time.perf_counter()
            stats = client.stats(COLONY, ha.colony_prv)
            seconds.append(time.perf_counter() - t0)
        rtt[i] = sum(seconds) / len(seconds)
    check(stats["executors"] == 0 and stats["blob"]["stores"] == 0, f"colonystats {stats}")
    mean = sum(rtt.values()) / len(rtt)
    st = ha.stats()
    print(f"{tag} colony {COLONY!r} created; 20 signed colonystats a replica: mean round trip "
          f"{mean * 1e3:.3f} ms ({', '.join(f'replica {i} {s * 1e3:.3f}' for i, s in rtt.items())}"
          f" ms); the broker process's colonystats counts its own blob stores: {stats['blob']}; "
          f"{st['threads']} threads, leader {st['leader']}, terms {st['terms']}")
    return {"start_s": ha.start_s, "rpc_mean_s": mean,
            "rpc_mean_s_by_replica": list(rtt.values()), "threads": st["threads"]}


def record_attempts(ex, log: list) -> None:
    """Wrap each of ``ex``'s handlers to log (processid, retries, executor
    name) of every attempt it is assigned."""
    for name, fn in list(ex._handlers.items()):
        def wrapped(ctx, *args, _fn=fn, **kwargs):
            log.append((ctx.process.processid, ctx.process.retries, ex.executorname))
            return _fn(ctx, *args, **kwargs)
        ex._handlers[name] = wrapped


def phase_ha_continuum(ha: HABroker, exec_stats: dict) -> tuple[dict, dict]:
    """DAG 1 of tests/test_integration_continuum.py at [executors-continuum]'s
    smoke size, float32, on the card, behind the three replicas: CFS on a
    ShardedStorage of 3 shards (R = 2) of which one dies (a seeded
    FaultPlan) once prepare_data is done; the two trainers crash at step 3
    on their first attempt; the leader replica is killed once the first
    crash is seen, so the failsafe's re-queue and the resume run on the new
    leader; evaluate; then the replica and the shard come back and a scrub
    restores 2 replicas of every key."""
    from repro_torch.configs import get_config
    from repro_torch.core.blobstore import ShardedStorage
    from repro_torch.core.client import Colonies
    from repro_torch.core.fs import MemoryStorage
    from repro_torch.core.spec import WorkflowSpec
    from repro_torch.runtime import faults
    from repro_torch.runtime import torch_executor as tx

    tag = "[ha-continuum]"
    t_phase = time.perf_counter()
    mods = kernel_modules()
    layers = get_config("stablelm-3b", "smoke").num_layers
    prv = ha.colony_prv
    client = ha.client
    store = ShardedStorage([MemoryStorage() for _ in range(3)], replicas=2)
    dead_shard = 1
    plan = faults.FaultPlan([faults.FaultRule(site, "crash", match={"shard": dead_shard},
                                              times=None) for site in ("blob.put", "blob.get")],
                            seed=HA_SEED)
    # [executors-continuum]'s lease (3x the hand-off's attempt) plus what a
    # failover can add to a healthy attempt's close
    allowance = failover_allowance_s()
    lease = math.ceil(3 * exec_stats["train_attempt_s"]) + allowance
    print(f"{tag} train lease {lease} s: 3 x [executors-continuum]'s hand-off attempt "
          f"({exec_stats['train_attempt_s']:.3f} s), rounded up, plus {allowance} s "
          f"for a failover (check-quorum step-down and the Raft commit timeout)")
    kw = dict(colony_prvkey=prv, device="cuda")
    attempts: list = []
    running = []

    def start(ex):
        running.append(ex)
        record_attempts(ex, attempts)
        ex.start(poll_timeout=0.2)
        return ex

    installed = killed = False
    try:
        start(tx.DataExecutor(Colonies(ha.transport()), COLONY, "ha-edge-1", "edge-data", store,
                              **kw))
        trainers = [start(tx.TrainerExecutor(Colonies(ha.transport()), COLONY, f"ha-h100-{c}",
                                             "h100-pod", store, die_at_step=3, **kw))
                    for c in "ab"]
        wf = WorkflowSpec.from_dict({"colonyname": COLONY, "functionspecs": [
            {"nodename": "prep", "funcname": "prepare_data",
             "kwargs": {"shards": 2, "tokens_per_shard": 256},
             "conditions": {"executortype": "edge-data", "dependencies": []},
             "maxexectime": 30},
            {"nodename": "train", "funcname": "train", "kwargs": dict(EXEC_TRAIN_KW, run="ha"),
             "conditions": {"executortype": "h100-pod", "dependencies": ["prep"]},
             "maxexectime": lease, "maxretries": 5},
            {"nodename": "eval", "funcname": "evaluate",
             "kwargs": {"arch": "stablelm-3b", "batch": 2, "seq_len": 16, "run": "ha",
                        "eval_batches": EXEC_EVAL_BATCHES},
             "conditions": {"executortype": "h100-pod", "dependencies": ["train"]},
             "maxexectime": 60 + allowance},
        ]})
        zero_launches(mods)
        t0 = time.perf_counter()
        r = client.submit_workflow(wf, prv)
        procs = {q["spec"]["nodename"]: q for q in r["processes"]}
        deadline = time.perf_counter() + 3 * lease + 300
        while not killed and time.perf_counter() < deadline:
            if not installed and client.get_process(procs["prep"]["processid"],
                                                    prv)["state"] == "successful":
                faults.install(plan)  # shard 1 dies before the first checkpoint
                installed = True
                print(f"{tag} prepare_data done after {time.perf_counter() - t0:.3f} s; blob "
                      f"shard {dead_shard} dead from here on")
            if installed and sum(t.failed for t in trainers):
                before = ha.leader()
                ha.command(f"kill {before}")
                killed = True
                print(f"{tag} first crash seen after {time.perf_counter() - t0:.3f} s; leader "
                      f"replica {before} killed")
            time.sleep(0.02)
        check(killed, "no trainer crashed")
        done = client.wait(procs["eval"]["processid"], prv, timeout=3 * lease + 300)
        dag_s = time.perf_counter() - t0
        dag = {name: mod.launches for name, mod in mods.items()}
    finally:
        for ex in running:
            ex.stop()
        if installed:
            faults.uninstall()
    st = ha.stats()
    after = int(st["leader"][1:]) if st["leader"] else None
    ha.command(f"revive {before}")
    final = {n: client.get_process(q["processid"], prv) for n, q in procs.items()}
    train_p = final["train"]
    failed = [t.failed for t in trainers]
    ev = done["out"][0] if done["out"] else None
    print(f"{tag} DAG 1 in {dag_s:.3f} s: {[(n, p['state'], p['retries']) for n, p in final.items()]}"
          f"; eval {ev or done['errors']}; trainers failed {failed}, processed "
          f"{[t.processed for t in trainers]}; leader replica {before} -> {after}; attempts "
          f"{[(a[0][:8], a[1], a[2]) for a in attempts]}; failover {st['failover']}")
    check(all(p["state"] == "successful" for p in final.values()),
          f"processes {[(n, p['state'], p['errors']) for n, p in final.items()]}")
    check(train_p["retries"] >= 1 and train_p["out"][0]["final_step"] == 3, f"train: {train_p}")
    check(after not in (None, before), f"the leader is {after} after killing replica {before}")
    keys = [(pid, retries) for pid, retries, _ in attempts]
    check(len(keys) == len(set(keys)), f"an attempt was assigned to two executors: {attempts}")
    # the bar [continuum] holds a crashed-and-resumed run to
    err = abs(ev["eval_ce"] - exec_stats["eval_ce"])
    print(f"{tag} eval_ce {ev['eval_ce']!r} against [executors-continuum]'s "
          f"{exec_stats['eval_ce']!r}: {err:.3e} (atol 1e-6)")
    check(math.isfinite(ev["eval_ce"]) and err <= 1e-6, f"eval_ce differs by {err}")
    want = {name: (4 * 2 + EXEC_EVAL_BATCHES) * layers if name == "flash_attention" else 0
            for name in mods}
    print(f"{tag} launches {dag} (want {want})")
    check(dag == want, f"launches {dag}, want {want}")
    degraded = sum(store.replica_count(k) < 2 for k in store.keys())
    report = store.scrub()
    blob = store.stats()
    full = all(store.replica_count(k) == 2 for k in store.keys())
    print(f"{tag} blob shard {dead_shard} back: {degraded} of {len(store.keys())} keys had one "
          f"replica; scrub {report}; every key on 2 replicas: {full}; counters: repairs "
          f"{blob['repairs']}, put_failures {blob['put_failures']}, get_failures "
          f"{blob['get_failures']}, per shard {json.dumps(blob['per_shard'])}")
    check(plan.fired() > 0 and degraded > 0, f"the dead shard fired {plan.fired()} faults")
    check(report["lost"] == 0 and report["repaired"] >= degraded and full,
          f"scrub {report}, {degraded} degraded")
    st = ha.stats()
    seconds = time.perf_counter() - t_phase
    print(f"{tag} broker after the revive: terms {st['terms']}, applied {st['applied']}, "
          f"journaled {st['journaled']}; {seconds:.1f} s")
    return dag, {"train_lease_s": lease, "dag1_s": dag_s, "trainers_failed": failed,
                 "train_retries": train_p["retries"], "eval_ce": ev["eval_ce"],
                 "eval_ce_err": err, "leader": [before, after], "blob_scrub": report,
                 "blob_degraded": degraded, "blob_repairs": blob["repairs"],
                 "failover": st["failover"], "seconds": seconds}


def phase_ha_serve_full(ha: HABroker, alone: dict) -> tuple[dict, dict]:
    """[executors-serve-full] behind the three replicas: full-width
    stablelm-3b (32 layers, float32) in a ServeExecutor behind a generator of
    queuesize 4, 8 signed requests in 2 batches, the leader replica killed
    after the first batch fires and before the second; throughout, a seeded
    ChaosMonkey kills and respawns CPU-only echo workers that drain a backlog
    of HA_BACKLOG processes in the same colony."""
    from repro_torch.core.client import Colonies
    from repro_torch.core.executor import ExecutorBase
    from repro_torch.core.fs import CFSClient, MemoryStorage
    from repro_torch.launch.serve import make_requests
    from repro_torch.runtime import torch_executor as tx
    from repro_torch.runtime.chaos import ChaosMonkey, SimulatedCrash
    from repro_torch.serve.batcher import InferenceClient, pad_prompts

    tag = "[ha-serve-full]"
    t_phase = time.perf_counter()
    mods = kernel_modules()
    client, prv = ha.client, ha.colony_prv
    storage = MemoryStorage()
    ex = tx.ServeExecutor(Colonies(ha.transport()), COLONY, "ha-serve-full", "h100-serve",
                          storage, colony_prvkey=prv, arch="stablelm-3b", variant="full",
                          max_len=max(PROMPT_LENS) + NEW_TOKENS, device="cuda")
    engine, cfg = ex.engine, ex.engine.cfg
    check(cfg.num_layers == 32 and cfg.param_dtype == "float32",
          f"{cfg.num_layers} layers, {cfg.param_dtype}")
    engine_s, batch_t = [], []  # the engine's s and start time per batch
    generate = engine.generate
    batch_started = threading.Event()

    def timed_generate(*args, **kwargs):
        batch_started.set()
        t = time.perf_counter()
        out = generate(*args, **kwargs)
        engine_s.append(time.perf_counter() - t)
        batch_t.append(t)
        return out

    class EchoWorker(ExecutorBase):
        """A CPU-only worker; killed, it dies holding its process."""

        dead = False

        def _execute(self, process) -> None:
            try:
                super()._execute(process)
            except SimulatedCrash:
                self._stop.set()  # never closed: the failsafe re-queues it

    # CPU-only echo workers; a killed one dies mid-process and a fresh one
    # replaces it
    pool, everyone = [], []
    echoed: list[str] = []  # the processid of every echo that returned

    def spawn() -> None:
        w = EchoWorker(Colonies(ha.transport()), COLONY, f"echo-{len(everyone)}", "cpu-echo",
                       colony_prvkey=prv)

        def echo(ctx, i, _w=w):
            time.sleep(0.02)
            if _w.dead:
                raise SimulatedCrash("killed by the chaos monkey")
            echoed.append(ctx.process.processid)
            return [i]

        w.register_function("echo", echo)
        w.start(poll_timeout=0.3)
        pool.append(w)
        everyone.append(w)

    def kill() -> None:
        if len(pool) > 1:
            victim = pool.pop(0)
            victim.dead = True
            victim._stop.set()  # its loop ends after the process it holds

    monkey = ChaosMonkey(kill, spawn, interval=(0.5, 2.0), seed=HA_SEED)
    engine.generate = timed_generate
    counted = trace.snapshot()["counters"]
    try:
        for _ in range(3):
            spawn()
        backlog = client.submit_workflow({"colonyname": COLONY, "functionspecs": [
            {"nodename": f"echo-{i}", "funcname": "echo", "args": [i], "maxexectime": 3,
             "maxretries": 20, "conditions": {"executortype": "cpu-echo", "dependencies": []}}
            for i in range(HA_BACKLOG)]}, prv)
        backlog_pids = [q["processid"] for q in backlog["processes"]]
        monkey.start()
        ex.start(poll_timeout=0.2)
        g = client.add_generator({"colonyname": COLONY, "name": "ha-serve-full", "queuesize": 4,
                                  "timeout": 60.0, "workflow": serve_workflow()}, prv)
        infc = InferenceClient(client, CFSClient(client, storage, prv), COLONY, g["generatorid"],
                               prv)
        requests = make_requests(PROMPT_LENS, cfg.vocab_size, NEW_TOKENS, seed=1)
        zero_launches(mods)
        t0 = time.perf_counter()
        rids = [infc.submit(r["prompt"], max_new_tokens=NEW_TOKENS) for r in requests[:4]]
        check(batch_started.wait(120), "the generator did not fire")
        before = ha.leader()
        ha.command(f"kill {before}")  # after the first batch fired, before the second
        t_kill = time.perf_counter()
        rids += [infc.submit(r["prompt"], max_new_tokens=NEW_TOKENS) for r in requests[4:]]
        served = {rid: infc.wait(rid, timeout=600) for rid in rids}
        wall_s = time.perf_counter() - t0
        counts = {name: mod.launches for name, mod in mods.items()}
        deadline = time.perf_counter() + 120
        while time.perf_counter() < deadline:
            stats = client.stats(COLONY, prv)
            if stats["waiting"] == 0 and stats["running"] == 0:
                break
            time.sleep(0.2)
        backlog_s = time.perf_counter() - t0
    finally:
        monkey.stop()
        ex.stop()
        for w in everyone:
            w.stop()
        engine.generate = generate
    st = ha.stats()
    after = st["leader"]
    ha.command(f"revive {before}")
    batches = [q for q in client.get_processes(COLONY, prv, state="successful", count=2000)
               if q["assignedexecutorid"] == ex.executorid]
    batches.sort(key=lambda q: q["submissiontime"])
    sizes = [len(q["spec"]["kwargs"]["packed_args"]) for q in batches]
    want = {name: 32 * len(batches) if name == "flash_attention" else 0 for name in mods}
    served = served_since(counted)
    print(f"{tag} {len(requests)} requests in {len(batches)} batches of {sizes}; served "
          f"{served}; serve executor processed {ex.processed}, failed {ex.failed}; "
          f"launches {counts} (want {want}); leader replica {before} -> {after}")
    check(sizes == [4, 4] and served["batches"] == 2 and ex.processed == 2
          and ex.failed == 0, f"batches of {sizes}, {served}, processed {ex.processed}")
    check(counts == want, f"launches {counts}, want {want}")
    check(after not in (None, f"n{before}"), f"the leader is {after} after killing {before}")
    for q in batches:
        packed = q["spec"]["kwargs"]["packed_args"]
        direct = engine.generate(pad_prompts(packed), max_new_tokens=NEW_TOKENS).tolist()
        check([served[r["request_id"]] for r in packed] == direct,
              "served tokens differ from the engine's own generate on the batch")
    # every backlog process ended, once: one successful close each, and
    # the closes the workers had accepted add up to the backlog
    final = {q["processid"]: q for q in client.get_processes(COLONY, prv, count=2000)}
    ends = [final[pid]["state"] for pid in backlog_pids]
    closes = sum(w.processed for w in everyone)
    retried = sum(final[pid]["retries"] > 0 for pid in backlog_pids)
    print(f"{tag} backlog of {HA_BACKLOG}: {ends.count('successful')} successful, "
          f"{ends.count('failed')} failed, {retried} re-queued after a worker died, closes "
          f"accepted {closes}, executed {len(echoed)} times; chaos monkey kills "
          f"{monkey.kills}, {len(everyone)} workers in all; drained {backlog_s:.3f} s after the "
          f"first request")
    check(all(s == "successful" for s in ends) and closes == HA_BACKLOG
          and set(echoed) == set(backlog_pids), f"backlog {ends.count('successful')} "
          f"successful of {HA_BACKLOG}, {closes} closes accepted")
    check(monkey.kills >= 1, "the chaos monkey killed no worker")
    fo = st["failover"]
    check(fo is not None and fo["elected_s"] is not None and fo["first_assign_s"] is not None,
          f"failover {fo}")
    n_tok = len(requests) * NEW_TOKENS
    outside = 1 - sum(engine_s) / wall_s
    stats = {"wall_s": wall_s, "tokens_per_s": n_tok / wall_s, "engine_s": engine_s,
             "outside_engine_share": outside, "failover": fo,
             "kill_to_second_batch_s": batch_t[1] - t_kill,
             "backlog_s": backlog_s, "monkey_kills": monkey.kills, "backlog_retried": retried,
             "broker_threads": st["threads"]}
    print(f"{tag} failover: a new leader {fo['elected_s']:.3f} s after the kill, its first assign "
          f"{fo['first_assign_s']:.3f} s after; first submit to last result {wall_s:.3f} s, "
          f"{n_tok / wall_s:.1f} tokens/s (alone, [executors-serve-full]: {alone['wall_s']:.3f} s, "
          f"{alone['tokens_per_s']:.1f}); engine per batch {[round(x, 4) for x in engine_s]} s "
          f"(alone {[round(x, 4) for x in alone['engine_s']]}); outside the engine {outside:.4f} "
          f"of the wall time (alone {alone['outside_engine_share']:.4f}); the second batch "
          f"started {stats['kill_to_second_batch_s']:.3f} s after the kill; broker threads "
          f"{st['threads']}")
    del ex, engine
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} {stats['seconds']:.1f} s")
    return counts, stats


# [contracts]: the port's six static gates, each in a child process of its
# own, all started together
CONTRACT_GATES = [["lint"], ["authlint"], ["replint"], ["idemlint"], ["authmap", "--check"],
                  ["replmap", "--check"]]


def phase_contracts() -> dict:
    """The port's four lints and its two matrices' drift checks
    (``python -m repro_torch.analysis.<gate>`` from the checkout's root,
    against ``TORCH_CONTRACTS.md``): each exits 0; then every broker
    process's detector report of this run, phase by phase."""
    tag = "[contracts]"
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    procs = [(gate, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.analysis.{gate[0]}", *gate[1:]], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for gate in CONTRACT_GATES]
    gates = {}
    for gate, t, proc in procs:
        out, _ = proc.communicate(timeout=300)
        lines = out.strip().splitlines()
        name = " ".join(gate)
        gates[name] = {"rc": proc.returncode, "s": time.perf_counter() - t,
                       "said": lines[-1] if lines else ""}
        print(f"{tag} {name}: exit {proc.returncode} after {gates[name]['s']:.3f} s: "
              f"{gates[name]['said']}")
        check(proc.returncode == 0, f"{tag} {name} failed:\n{out[-4000:]}")
    longest: dict[str, dict[str, float]] = {}
    for rep in REPORTS:
        for fam, (_, ms) in rep["holds"].items():
            longest.setdefault(rep["tag"], {})[fam] = ms
        print(f"{tag} report at the end of {rep['tag']}: {len(rep['violations'])} lock-order "
              f"violations, {len(rep['contract_errors'])} contract errors, holds "
              f"{json.dumps(rep['holds'])}")
    seconds = time.perf_counter() - t0
    print(f"{tag} six gates at 0 violations in {seconds:.3f} s; {len(REPORTS)} broker reports, "
          f"every one with 0 violations and 0 contract errors")
    return {"gates": gates, "longest_hold_ms": longest, "seconds": seconds}


def phase_launch_serve() -> tuple[dict, dict]:
    """``launch.serve.main`` of full-width stablelm-3b on the card: the
    broker in this process, a ServeExecutor (float32) behind a generator of
    queuesize 4, 8 requests in 2 waves. 2 batches of 4, exactly 32 flash
    attention launches a prefill and none of the scans, greedy tokens equal
    to the engine's own generate on each batch the broker formed, and every
    served prefill's cache equal to ``abstract_cache`` in paths, shapes and
    dtypes; wall time, tokens/s and the share outside the engine."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import abstract_cache
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.batcher import pad_prompts
    from repro_torch.tree import leaves_with_names

    tag = "[launch]"
    t_phase = time.perf_counter()
    mods = kernel_modules()
    generate, prefill = engine_mod.ServeEngine.generate, engine_mod.prefill
    engine_s, caches = [], []

    def timed_generate(self, *args, **kwargs):  # the engine's own time per batch
        t = time.perf_counter()
        out = generate(self, *args, **kwargs)  # ends in a copy to the host
        engine_s.append(time.perf_counter() - t)
        return out

    def recorded_prefill(*args, **kwargs):  # the structure of each served prefill's cache
        logits, cache = prefill(*args, **kwargs)
        caches.append([(n, tuple(t.shape), t.dtype, t.device.type)
                       for n, t in leaves_with_names(cache)])
        return logits, cache

    engine_mod.ServeEngine.generate, engine_mod.prefill = timed_generate, recorded_prefill
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_launches(mods)
        res = serve_cli.main(LAUNCH_SERVE_ARGS)
        counts = {name: mod.launches for name, mod in mods.items()}
    finally:
        engine_mod.ServeEngine.generate, engine_mod.prefill = generate, prefill
    engine, batches = res["engine"], res["batches"]
    cfg = engine.cfg
    sizes = [len(b) for b in batches]
    want = {name: 32 * len(batches) if name == "flash_attention" else 0 for name in mods}
    print(f"{tag} launch.serve {' '.join(LAUNCH_SERVE_ARGS)}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype}; batches of {sizes}; served {res['stats']}; "
          f"launches {counts} (want {want})")
    check(cfg.num_layers == 32 and cfg.d_model == 2560 and cfg.param_dtype == "float32",
          f"served {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.param_dtype}")
    check(sizes == [4, 4] and res["stats"]["batches"] == 2 and res["stats"]["requests"] == 8,
          f"batches of {sizes}, served {res['stats']}")
    check(counts == want, f"launches {counts}, want {want}")
    reqs = {r["request_id"]: r for r in res["requests"]}
    for i, batch in enumerate(batches):
        packed = [reqs[rid] for rid in batch]
        direct = engine.generate(pad_prompts(packed), max_new_tokens=16).tolist()
        check([r["tokens"] for r in packed] == direct,
              "tokens served through launch.serve differ from the engine's own generate")
        if i == 0:
            hold_to_eager(engine, packed, direct, tag)
    abstract = [(n, tuple(t.shape), t.dtype, t.device.type)
                for n, t in leaves_with_names(abstract_cache(cfg, 4, engine.max_len))]
    check(len(caches) == 2, f"{len(caches)} served prefills, want 2")
    for cache in caches:
        check([c[:3] for c in cache] == [a[:3] for a in abstract],
              f"the served prefill's cache {cache} differs from abstract_cache's {abstract}")
        check({c[3] for c in cache} == {"cuda"} and {a[3] for a in abstract} == {"meta"},
              "devices of the served and the abstract cache")
    print(f"{tag} served tokens identical to generate on each batch the broker formed; "
          f"abstract_cache(cfg, 4, {engine.max_len}) equals both served prefills' caches: "
          f"{abstract}")
    n_tok = res["stats"]["tokens"]
    stats = {"wall_s": res["wall_s"], "tokens_per_s": n_tok / res["wall_s"],
             "requests_per_s": res["stats"]["requests"] / res["wall_s"], "engine_s": engine_s,
             "outside_engine_share": 1 - sum(engine_s) / res["wall_s"],
             "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"{tag} first submit to last result {res['wall_s']:.3f} s: {stats['tokens_per_s']:.1f} "
          f"tokens/s, {stats['requests_per_s']:.3f} requests/s; engine per batch "
          f"{[round(x, 4) for x in engine_s]} s; outside the engine (signed RPCs, CFS, the "
          f"waves' generator waits) {stats['outside_engine_share']:.4f} of the wall time; "
          f"max_memory_allocated {stats['peak_bytes']} bytes")
    del res, engine
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} serve {stats['seconds']:.1f} s")
    return counts, stats


def _launch_train_cli(args: list[str]) -> tuple[list, dict, float]:
    """``launch.train.main(args)`` under deterministic algorithms, its two
    printed JSON documents checked against what it returned: the outputs,
    each kernel's launches and the seconds it took."""
    import contextlib
    import io

    from repro_torch.launch import train as train_cli

    mods = kernel_modules()
    torch.use_deterministic_algorithms(True)
    try:
        zero_launches(mods)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            outs = train_cli.main(args)
        seconds = time.perf_counter() - t0
        counts = {name: mod.launches for name, mod in mods.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    text = printed.getvalue()
    decoder = json.JSONDecoder()
    first, end = decoder.raw_decode(text)
    second, _ = decoder.raw_decode(text[end:].lstrip())
    print(f"[launch] launch.train {' '.join(args)} printed {json.dumps(first)} and "
          f"{json.dumps(second)} in {seconds:.3f} s")
    check([first, second] == outs, "launch.train returned other outputs than it printed")
    return outs, counts, seconds


def _launch_train_direct(kw: dict) -> tuple[list, list]:
    """``train_loop.train`` then ``evaluate`` called directly on the card
    with ``kw``, against a ``MemoryStore``, under deterministic algorithms."""
    from repro_torch.runtime import train_loop as tl
    from repro_torch.runtime.store import MemoryStore

    torch.use_deterministic_algorithms(True)
    try:
        store = MemoryStore()
        want = tl.train(store, "launch", device="cuda", **kw)
        want_ev = tl.evaluate(store, "launch", device="cuda",
                              **{k: kw[k] for k in ("arch", "variant", "optimizer", "batch",
                                                    "seq_len", "run", "use_pallas")})
    finally:
        torch.use_deterministic_algorithms(False)
    return want, want_ev


def _check_launch_train(outs: list, want: list, want_ev: list, counts: dict, kw: dict) -> None:
    """``launch.train``'s outputs within ``LAUNCH_ATOL`` of the direct
    handlers', and flash attention's exact launches: each step's forward
    and remat recomputation, then one forward per eval batch."""
    from repro_torch.configs import get_config

    tag = "[launch]"
    cfg = get_config(kw["arch"], kw["variant"])
    check(cfg.remat == "full", f"{kw['variant']} remat {cfg.remat}")
    (got,), (got_ev,) = outs
    err = max([abs(got["metrics"][k] - want[0]["metrics"][k]) for k in want[0]["metrics"]]
              + [abs(got_ev["eval_ce"] - want_ev[0]["eval_ce"])])
    print(f"{tag} {kw['variant']}: direct train_loop.train/evaluate: {json.dumps(want)} "
          f"{json.dumps(want_ev)}; largest difference {err:.3e} (atol {LAUNCH_ATOL})")
    check(got["final_step"] == want[0]["final_step"] == kw["steps"] - 1
          and got_ev["step"] == want_ev[0]["step"] == got["final_step"],
          f"steps {got['final_step']} {got_ev['step']}, direct {want} {want_ev}")
    check(set(got["metrics"]) == set(want[0]["metrics"]) and err <= LAUNCH_ATOL,
          f"launch.train differs from the direct handlers by {err}")
    check(all(math.isfinite(v) for v in got["metrics"].values())
          and math.isfinite(got_ev["eval_ce"]), f"non-finite outputs {outs}")
    want_counts = {name: (kw["steps"] * 2 + EXEC_EVAL_BATCHES) * cfg.num_layers
                   if name == "flash_attention" else 0 for name in counts}
    print(f"{tag} {kw['variant']}: launch.train launches {counts} (want {want_counts})")
    check(counts == want_counts, f"launch.train launches {counts}, want {want_counts}")


def phase_launch_train() -> dict:
    """``launch.train.main`` of the smoke run on the card, through a
    TrainerExecutor behind the broker (run in a process of its own,
    ``--launch-train``), held to ``train_loop.train``/``evaluate`` called
    directly with the same arguments in the same process."""
    outs, counts, _ = _launch_train_cli(LAUNCH_TRAIN_ARGS)
    _check_launch_train(outs, *_launch_train_direct(LAUNCH_TRAIN_KW), counts, LAUNCH_TRAIN_KW)
    return counts


def phase_launch_train_full_cli() -> dict:
    """``launch.train.main`` of full-width stablelm-3b (float32, AdamW, 2
    steps and one checkpoint of the whole state through signed CFS, then
    ``evaluate`` restoring it) in a process of its own
    (``--launch-train-full``): its outputs, launches, seconds, and the
    peaks of device and host memory."""
    import resource

    from repro_torch.train.checkpoint import CheckpointManager

    save, restore = CheckpointManager.save, CheckpointManager.restore
    ckpt_s: dict[str, list[float]] = {"save_s": [], "restore_s": []}

    def timed(fn, key):  # each save's and restore's seconds, the device finished
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ckpt_s[key].append(time.perf_counter() - t)
            return out
        return run

    CheckpointManager.save, CheckpointManager.restore = timed(save, "save_s"), timed(restore,
                                                                                    "restore_s")
    torch.cuda.reset_peak_memory_stats()
    try:
        outs, counts, seconds = _launch_train_cli(LAUNCH_TRAIN_FULL_ARGS)
    finally:
        CheckpointManager.save, CheckpointManager.restore = save, restore
    return {"outs": outs, "counts": counts, "seconds": seconds, **ckpt_s,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "host_peak_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


def phase_launch_train_full_direct() -> dict:
    """The direct handlers with ``LAUNCH_TRAIN_FULL_KW`` in a process of
    their own (``--launch-train-full-direct``): the host could not hold
    both runs' checkpoints at once."""
    t0 = time.perf_counter()
    want, want_ev = _launch_train_direct(LAUNCH_TRAIN_FULL_KW)
    return {"want": want, "want_ev": want_ev, "seconds": time.perf_counter() - t0}


def phase_launch_train_full() -> tuple[dict, dict]:
    """Full-width ``launch.train`` against the direct handlers, each in a
    child process, with flash attention's exact launches (2 steps x 32
    layers x forward and recomputation, 2 eval batches x 32 layers)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[launch] before full-width launch.train: this process holds "
          f"{torch.cuda.memory_allocated()} bytes, {torch.cuda.mem_get_info()[0]} free")
    cli = child_phase("--launch-train-full", "[launch]")
    direct = child_phase("--launch-train-full-direct", "[launch]")
    _check_launch_train(cli["outs"], direct["want"], direct["want_ev"], cli["counts"],
                        LAUNCH_TRAIN_FULL_KW)
    check(len(cli["save_s"]) == 1 and len(cli["restore_s"]) == 1,
          f"{cli['save_s']} saves and {cli['restore_s']} restores, want one each")
    stats = {k: cli[k] for k in ("seconds", "save_s", "restore_s", "peak_bytes",
                                 "host_peak_bytes")}
    stats["direct_seconds"] = direct["seconds"]
    print(f"[launch] full-width launch.train {cli['seconds']:.3f} s (direct handlers "
          f"{direct['seconds']:.3f} s); the checkpoint through signed CFS: save "
          f"{cli['save_s'][0]:.3f} s, restore {cli['restore_s'][0]:.3f} s; "
          f"max_memory_allocated {cli['peak_bytes']} bytes, host max RSS "
          f"{cli['host_peak_bytes']} bytes")
    return cli["counts"], stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    t0, marks = time.perf_counter(), {}

    def mark(phase: str) -> None:  # seconds from the start at the phase's end
        marks[phase] = round(time.perf_counter() - t0, 1)

    card = phase_card()
    phase_build()
    worst_err = phase_kernel_cases()
    worst_wkv = phase_wkv_cases()
    worst_mamba = phase_mamba_cases()
    grad_stats = phase_grad()
    mark("kernels and grad")
    stablelm_counts, stats = phase_slice("stablelm-3b", "full", PROMPT_LENS, {"flash_attention": 32},
                                         after=dryrun_serve_checks)
    dryrun_counts = stats.pop("launches")
    dryrun_rows = stats.pop("dryrun")
    mark("slice stablelm-3b")
    rwkv_counts, rwkv_stats = phase_slice("rwkv6-7b", "full", PRIME_PROMPT_LENS, {"rwkv6_wkv": 32})
    mark("slice rwkv6-7b")
    jamba_counts, jamba_stats = phase_slice("jamba-1.5-large-398b", "no-moe", PRIME_PROMPT_LENS,
                                            JAMBA_PER_PREFILL)
    mark("slice jamba")
    mixtral_counts, mixtral_stats = phase_slice("mixtral-8x7b", "half-depth", PROMPT_LENS,
                                                MIXTRAL_PER_PREFILL, after=mixtral_checks)
    swa_counts = mixtral_stats.pop("launches")
    mark("slice mixtral")
    print(f"[slice deepseek-v3-671b] mixtral freed: {torch.cuda.memory_allocated()} bytes "
          f"allocated, {torch.cuda.mem_get_info()[0]} free")
    deepseek_counts, deepseek_stats = phase_slice("deepseek-v3-671b", "two-moe", PROMPT_LENS,
                                                  DEEPSEEK_PER_PREFILL, after=deepseek_checks)
    absorb_counts = deepseek_stats.pop("launches")
    mark("slice deepseek")
    vision_counts, vision_stats = phase_slice("llama-3.2-vision-11b", "full", PROMPT_LENS,
                                              VISION_PER_PREFILL, after=xattn_checks)
    vision_check_counts = vision_stats.pop("launches")
    mark("slice llama-vision")
    seamless_counts, seamless_stats = phase_slice("seamless-m4t-large-v2", "full", PROMPT_LENS,
                                                  SEAMLESS_PER_PREFILL, after=xattn_checks)
    seamless_check_counts = seamless_stats.pop("launches")
    mark("slice seamless")
    phase_cross_device("granite-3-8b", "smoke", 72)
    phase_cross_device("rwkv6-7b", "smoke", 72, reseed_rwkv)
    phase_cross_device("jamba-1.5-large-398b", "smoke-no-moe", 67, reseed_jamba)
    phase_cross_device("mixtral-8x7b", "smoke", 72)
    phase_cross_device("jamba-1.5-large-398b", "smoke", 67, reseed_jamba)
    phase_cross_device("starcoder2-15b", "smoke", 72)
    phase_cross_device("qwen2.5-14b", "smoke", 72)
    phase_cross_device("deepseek-v3-671b", "smoke", 72)
    cross_device_counts = {arch: phase_cross_device(arch, "smoke", 72, reseed_gates)
                           for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2")}
    mark("cross")
    train_counts, train_stats = phase_train_full(grad_stats)
    dryrun_rows[DRYRUN_CELLS[2][0]] = phase_dryrun_train(train_stats)
    mark("train-full and dryrun train")
    print(f"[train-graph] this process holds {torch.cuda.memory_allocated()} bytes, "
          f"{torch.cuda.mem_get_info()[0]} free")
    graph_run = child_phase("--train-graph", "[train-graph]")
    graph_counts, graph_stats = graph_run["counts"], graph_run["stats"]
    if "profiled_busy_s" in train_stats and "profiled_busy_s" in graph_stats["captured"]:
        idle = {name: 1 - r["profiled_busy_s"] / r["profiled_wall_s"]
                for name, r in (("eager", train_stats), ("captured", graph_stats["captured"]))}
        print(f"[train-graph] idle share of a profiled step: eager {idle['eager']:.4f} "
              f"([train-full]'s), captured {idle['captured']:.4f}; median s a step: eager "
              f"{graph_stats['eager']['median_step_s']:.4f}, captured "
              f"{graph_stats['captured']['median_step_s']:.4f}")
    mark("train-graph")
    continuum_counts = child_phase("--continuum", "[continuum]")
    mark("continuum")
    cross_counts, cross_worst = phase_train_cross()
    mark("train-cross")
    broker = Broker()
    try:
        broker_stats = phase_broker(broker)
        broker.report("[broker]")
        executor_counts, executor_stats = phase_executors_continuum(broker)
        broker.report("[executors-continuum]")
        serve_exec_counts, serve_exec_stats = phase_executors_serve_full(broker)
        check(broker.alive(), "the broker process died")
        broker.report("[executors-serve-full]", MEMORY_FAMILIES)
    finally:
        broker.close()
    mark("broker and executors")
    from repro_torch.core.retry import RetryPolicy

    written, written_s = durable_file()
    durable = Broker(str(DURABLE_DB), RetryPolicy(**DURABLE_RETRY_KW))
    try:
        durable_stats = phase_durable_broker(durable, written, written_s, broker_stats)
        durable_cont_counts, durable_cont_stats = phase_durable_continuum(durable)
        durable_serve_counts, durable_serve_stats = phase_durable_serve_full(durable,
                                                                             serve_exec_stats)
        check(durable.alive(), "the broker process died")
        durable.report("[durable-serve-full]", SQLITE_FAMILIES)
    finally:
        durable.close()
    mark("durable")
    ha = HABroker()
    try:
        ha_broker_stats = phase_ha_broker(ha)
        ha.report("[ha-broker]")
        ha_cont_counts, ha_cont_stats = phase_ha_continuum(ha, executor_stats)
        ha.report("[ha-continuum]")
        ha_serve_counts, ha_serve_stats = phase_ha_serve_full(ha, serve_exec_stats)
        check(ha.alive(), "the replicated broker process died")
        ha.report("[ha-serve-full]", HA_FAMILIES)
    finally:
        ha.close()
    mark("ha")
    contracts_stats = phase_contracts()
    mark("contracts")
    launch_serve_counts, launch_stats = phase_launch_serve()
    mark("launch serve")
    launch_train_counts = child_phase("--launch-train", "[launch]")
    mark("launch train")
    launch_full_counts, launch_full_stats = phase_launch_train_full()
    mark("launch train full")
    foreign = reference_modules(sys.modules)
    print(f"[broker] stopped; modules of the reference or of JAX in this process: {foreign}")
    check(not foreign, f"this process imported {foreign}")
    paths = {"stablelm-3b": stablelm_counts, "rwkv6-7b": rwkv_counts,
             "jamba-1.5-large-398b": jamba_counts, "stablelm-3b train": train_counts,
             "stablelm-3b train-graph": graph_counts,
             "stablelm-3b continuum": continuum_counts,
             "stablelm-3b executors-continuum": executor_counts,
             "stablelm-3b executors-serve-full": serve_exec_counts,
             "stablelm-3b durable-continuum": durable_cont_counts,
             "stablelm-3b durable-serve-full": durable_serve_counts,
             "stablelm-3b ha-continuum": ha_cont_counts,
             "stablelm-3b ha-serve-full": ha_serve_counts,
             "stablelm-3b launch-serve": launch_serve_counts,
             "stablelm-3b launch-train": launch_train_counts,
             "stablelm-3b launch-train-full": launch_full_counts,
             "stablelm-3b dryrun": dryrun_counts}
    earlier = {name: sum(c[name] for c in paths.values()) for name in kernel_modules()}
    paths.update({"mixtral-8x7b half-depth": mixtral_counts, "mixtral-8x7b checks": swa_counts,
                  "deepseek-v3-671b two-moe": deepseek_counts,
                  "deepseek-v3-671b checks": absorb_counts,
                  "llama-3.2-vision-11b full": vision_counts,
                  "llama-3.2-vision-11b checks": vision_check_counts,
                  "seamless-m4t-large-v2 full": seamless_counts,
                  "seamless-m4t-large-v2 checks": seamless_check_counts,
                  **{f"{arch} cross": c for arch, c in cross_device_counts.items()},
                  **{f"{arch} train-cross": c for arch, c in cross_counts.items()}})
    launches = {name: sum(c[name] for c in paths.values()) for name in kernel_modules()}
    print(f"[done] launches per path {json.dumps(paths)}; summed {json.dumps(launches)} "
          f"({json.dumps(earlier)} on the paths before mixtral and train-cross)")
    flash_row, flash_serving = phase_timing(worst_err, launches["flash_attention"])
    kernels = [flash_row]
    wkv_row, prime = phase_wkv_timing(worst_wkv, launches["rwkv6_wkv"])
    mamba_row, serving = phase_mamba_timing(worst_mamba, launches["mamba_scan"])
    kernels += [wkv_row, mamba_row]
    mark("timing")
    print(f"[done] {time.perf_counter() - t0:.1f} s; serving stablelm-3b {json.dumps(stats)}; "
          f"flash attention at serving shapes {json.dumps(flash_serving)}")
    print(f"[done] serving rwkv6-7b {json.dumps(rwkv_stats)}; WKV at a prime prompt "
          f"{json.dumps(prime)}")
    print(f"[done] serving jamba-1.5-large-398b no-moe {json.dumps(jamba_stats)}; Mamba scan at "
          f"serving shapes {json.dumps(serving)}")
    print(f"[done] serving mixtral-8x7b half-depth {json.dumps(mixtral_stats)}")
    print(f"[done] serving deepseek-v3-671b two-moe {json.dumps(deepseek_stats)}")
    print(f"[done] serving llama-3.2-vision-11b full {json.dumps(vision_stats)}")
    print(f"[done] serving seamless-m4t-large-v2 full {json.dumps(seamless_stats)}")
    print(f"[done] training stablelm-3b {json.dumps(train_stats)}; flash attention at the training "
          f"shape: forward {grad_stats['fwd_ms']:.4f} ms, backward {grad_stats['bwd_ms']:.4f} ms a "
          f"layer, its gradients within {grad_stats['worst_err']:.3e} of the plain twin's "
          f"(rwkv6_chunked {grad_stats['wkv_grad_err']:.3e}, mamba_chunk_scan "
          f"{grad_stats['mamba_grad_err']:.3e}); train cuda vs cpu {json.dumps(cross_worst)}")
    print(f"[done] train-graph {json.dumps(graph_stats)}")
    print(f"[done] broker {json.dumps(broker_stats)}; executors-continuum "
          f"{json.dumps(executor_stats)}; executors-serve-full {json.dumps(serve_exec_stats)}")
    print(f"[done] durable-broker {json.dumps(durable_stats)}; durable-continuum "
          f"{json.dumps(durable_cont_stats)}; durable-serve-full {json.dumps(durable_serve_stats)}")
    print(f"[done] ha-broker {json.dumps(ha_broker_stats)}; ha-continuum "
          f"{json.dumps(ha_cont_stats)}; ha-serve-full {json.dumps(ha_serve_stats)}")
    print(f"[done] contracts {json.dumps(contracts_stats)}")
    print(f"[done] launch.serve {json.dumps(launch_stats)}; launch.train full "
          f"{json.dumps(launch_full_stats)}")
    print(f"[done] dryrun {json.dumps(dryrun_rows)}")
    print(f"[done] seconds from the start at the end of each phase {json.dumps(marks)}; "
          f"the whole script {time.perf_counter() - t0:.1f} s")
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


CHILD_PHASES = {"--train-graph": phase_train_graph, "--continuum": phase_continuum,
                "--launch-train": phase_launch_train,
                "--launch-train-full": phase_launch_train_full_cli,
                "--launch-train-full-direct": phase_launch_train_full_direct}

if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] in CHILD_PHASES:
        check(torch.cuda.is_available(), "no CUDA device")
        print(json.dumps(CHILD_PHASES[sys.argv[1]]()))
        sys.exit(0)
    sys.exit(main())
