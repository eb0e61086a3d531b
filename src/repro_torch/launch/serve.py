"""Serving launcher of the port: builds a ``ServeEngine`` on the card and
answers a request load through the generator batch handler, publishing
each result into an in-memory CFS (``runtime.store.MemoryStore``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b --variant full --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --variant no-moe
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --variant half-depth
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --variant two-moe

Weights are random, drawn from ``--seed``. The broker wiring (a torch
executor registered with a Colonies server) is not ported yet.
llama-3.2-vision-11b and seamless-m4t-large-v2 cross-attend to a memory
the batch handler does not pass (as in the reference), so here they raise
``ValueError`` naming it; serve them with ``ServeEngine.generate(...,
extras=...)``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.model import dtype_of
from ..models.spec import init_params, model_spec
from ..runtime.store import MemoryStore
from ..serve.batcher import make_batch_handler, result_tokens
from ..serve.engine import ServeEngine


def build_engine(arch: str, variant: str, max_len: int, seed: int = 0,
                 device: str | torch.device = "cuda") -> ServeEngine:
    """Config + random weights from ``seed``, built directly on ``device``."""
    cfg = get_config(arch, variant)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(model_spec(cfg), gen, dtype_of(cfg.param_dtype), dev)
    return ServeEngine(cfg, params, max_len=max_len, device=dev)


def make_requests(prompt_lens: list[int], vocab: int, max_new_tokens: int,
                  seed: int = 0) -> list[dict]:
    """Requests as the generator packs them, with prompts drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [
        {"request_id": f"req-{i:04d}", "prompt": rng.integers(0, vocab, n).tolist(),
         "max_new_tokens": max_new_tokens}
        for i, n in enumerate(prompt_lens)
    ]


def serve(engine: ServeEngine, requests: list[dict], batch_size: int, sink,
          colony: str = "serve") -> list[float]:
    """Answer ``requests`` in batches of ``batch_size``; returns the wall
    seconds of each batch, taken after the device has finished it."""
    handler = make_batch_handler(engine, sink, colony)
    seconds = []
    for i in range(0, len(requests), batch_size):
        t0 = time.perf_counter()
        handler(None, packed_args=requests[i : i + batch_size])
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--variant", default="full",
                    help="full | smoke | an arch's own variant (jamba: no-moe, smoke-no-moe; "
                         "mixtral: half-depth; deepseek-v3-671b: two-moe)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-prompt-len", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = build_engine(args.arch, args.variant, args.max_prompt_len + args.max_new_tokens,
                          args.seed, args.device)
    lens = np.random.default_rng(args.seed).integers(1, args.max_prompt_len + 1, args.requests)
    requests = make_requests(lens.tolist(), engine.cfg.vocab_size, args.max_new_tokens, args.seed)
    sink = MemoryStore()
    seconds = serve(engine, requests, args.batch_size, sink)
    for r in requests:
        print(r["request_id"], len(r["prompt"]), result_tokens(sink, "serve", r["request_id"]))
    st = engine.stats
    print(f"{st['requests']} requests in {st['batches']} batches, {st['tokens']} tokens, "
          f"{sum(seconds):.3f}s on {engine.device} (per batch: {[round(t, 4) for t in seconds]})")


if __name__ == "__main__":
    main()
