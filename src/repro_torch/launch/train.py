"""Training launcher of the port: ``--arch <id>`` runs the training loop
of ``runtime.train_loop`` on the card, then evaluates its last checkpoint,
against an in-memory CFS (``MemoryStore``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --steps 20

It takes the reference launcher's arguments (plus ``--device``) and
prints the training handler's output as JSON, then the evaluation's. As
in the reference, the handlers build the variant in float32. The broker
wiring (a torch executor behind a Colonies server, with lease-based
fault tolerance) is not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import argparse
import json

from ..runtime.store import MemoryStore
from ..runtime.train_loop import evaluate, train


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"],
                    help="smoke | full, the reference launcher's choices (an arch's own "
                         "variants, e.g. mixtral's half-depth, are served by launch.serve)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--learning-rate", type=float, default=3e-4)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--run", default="cli-run")
    ap.add_argument("--use-pallas", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    kw = {
        "arch": args.arch, "variant": args.variant, "steps": args.steps,
        "batch": args.batch, "seq_len": args.seq_len,
        "microbatches": args.microbatches, "optimizer": args.optimizer,
        "learning_rate": args.learning_rate,
        "checkpoint_every": args.checkpoint_every, "run": args.run,
        "use_pallas": args.use_pallas,
    }
    store = MemoryStore()
    out = train(store, "launch", device=args.device, **kw)
    print(json.dumps(out, indent=1))
    print(json.dumps(evaluate(store, "launch", device=args.device, arch=args.arch,
                              variant=args.variant, optimizer=args.optimizer, batch=args.batch,
                              seq_len=args.seq_len, run=args.run, use_pallas=args.use_pallas),
                     indent=1))


if __name__ == "__main__":
    main()
