#!/usr/bin/env python3
"""Decode milliseconds a step of the port's serving path, for comparing two
trees of the port on one card.

    python3 scripts/decode_step_ms.py                        # this checkout's src/
    python3 scripts/decode_step_ms.py --src /path/to/other/src --label parent

Builds ``--arch``/``--variant`` with random weights from seed 0 through
``repro_torch.launch.serve.build_engine`` (imported from ``--src``),
prefills a batch of ``--batch`` random prompts of ``--prompt`` tokens, then
times ``--steps`` greedy ``decode_step`` calls at Python-int positions, the
serving loop's own, ``--repeats`` times from a copy of the same cache. Each
repeat is one wall-clock window over all its steps, ended by a device
synchronize: decode is host-bound, so this is the host's time a step. It
prints one line per repeat and, last, one JSON object with the median,
every repeat's ms a step, the card and its power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--variant", default="full")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch

    if not torch.cuda.is_available():
        sys.exit("decode_step_ms.py needs a CUDA card")
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import decode_step, prefill
    from repro_torch.tree import map_leaves

    import repro_torch

    max_len = args.prompt + args.steps + 1
    engine = build_engine(args.arch, args.variant, max_len=max_len, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, engine.cfg.vocab_size, (args.batch, args.prompt), generator=gen,
                           device="cuda")
    per_step = []
    with torch.inference_mode():
        logits, cache0 = prefill(engine.params, engine.cfg, {"tokens": tokens}, max_len)
        first = logits.argmax(-1).reshape(args.batch, 1)
        out_tokens = None
        for rep in range(args.repeats + 1):  # the first repeat warms up
            cache, tok, seen = map_leaves(torch.clone, cache0), first, []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for pos in range(args.prompt, args.prompt + args.steps):
                logits, cache = decode_step(engine.params, engine.cfg, tok, cache, pos)
                tok = logits.argmax(-1).reshape(args.batch, 1)
                seen.append(tok)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / args.steps
            got = torch.cat(seen, dim=1).cpu()
            if out_tokens is None:
                out_tokens = got
            elif not torch.equal(got, out_tokens):
                sys.exit(f"{args.label}: repeat {rep} decoded other tokens")
            if rep:
                per_step.append(ms)
                print(f"[decode-ms] {args.label}: repeat {rep}: {ms:.4f} ms a step")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "label": args.label, "package": str(Path(repro_torch.__file__).parent),
        "arch": args.arch, "variant": args.variant, "batch": args.batch,
        "prompt": args.prompt, "steps": args.steps,
        "median_ms_per_step": statistics.median(per_step), "ms_per_step": per_step,
        "tokens_checksum": int(out_tokens.sum()), "card": card.strip().splitlines()[0],
        "torch": torch.__version__,
    }))


if __name__ == "__main__":
    main()
