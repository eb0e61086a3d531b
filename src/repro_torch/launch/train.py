"""Training launcher of the port: ``--arch <id>`` runs the colony-dispatched
training loop on the card, then evaluates its last checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --steps 20 --device cpu

As in the reference, the run is submitted as a ColonyOS function
specification to a broker (``repro_torch.broker.standalone_server``, in
this process) and executed by a ``TrainerExecutor`` on ``--device``, the
path the continuum takes, so checkpoints, lease-based fault tolerance and
the CFS hand-off all apply. It takes the reference launcher's arguments
(plus ``--device``) and prints the ``train`` process's output as JSON.
Then, unlike the reference, it submits an ``evaluate`` spec for the same
run to the same executor and prints that output too. It exits 1 unless
both processes succeeded. As in the reference, the handlers build the
variant in float32.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..broker import standalone_server
from ..core import Colonies, Crypto, FunctionSpec, InProcTransport
from ..core.fs import MemoryStorage
from ..runtime.torch_executor import TrainerExecutor

TRAIN_S = 24 * 3600  # maxexectime of each process, as the reference sets it
EXECUTORTYPE = "torch-pod"


def main(argv: list[str] | None = None) -> list[list]:
    """Returns the two outputs it printed: ``train``'s, then ``evaluate``'s."""
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

    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    server = standalone_server(Crypto.id(server_prv))
    server.start_background(failsafe_interval=0.2)
    trainer = None
    try:
        client = Colonies(InProcTransport([server]))
        client.add_colony("launch", Crypto.id(colony_prv), server_prv)
        trainer = TrainerExecutor(client, "launch", "trainer-0", EXECUTORTYPE, MemoryStorage(),
                                  colony_prvkey=colony_prv, device=args.device)
        trainer.start(poll_timeout=0.2)

        def run(funcname: str, kwargs: dict) -> dict:
            spec = FunctionSpec.from_dict({
                "conditions": {"colonyname": "launch", "executortype": EXECUTORTYPE},
                "funcname": funcname, "kwargs": kwargs,
                "maxexectime": TRAIN_S, "maxretries": 3,
            })
            p = client.submit(spec, colony_prv)
            done = client.wait(p["processid"], colony_prv, timeout=TRAIN_S)
            print(json.dumps(done["out"], indent=1))
            outs.append(done["out"])
            if done["state"] != "successful":
                print(f"{funcname} {done['state']}: {done['errors']}", file=sys.stderr)
            return done

        outs = []
        done = run("train", {
            "arch": args.arch, "variant": args.variant, "steps": args.steps,
            "batch": args.batch, "seq_len": args.seq_len,
            "microbatches": args.microbatches, "optimizer": args.optimizer,
            "learning_rate": args.learning_rate,
            "checkpoint_every": args.checkpoint_every, "run": args.run,
            "use_pallas": args.use_pallas,
        })
        if done["state"] == "successful":
            done = run("evaluate", {
                "arch": args.arch, "variant": args.variant, "optimizer": args.optimizer,
                "batch": args.batch, "seq_len": args.seq_len, "run": args.run,
                "use_pallas": args.use_pallas,
            })
    finally:
        if trainer is not None:
            trainer.stop()
        server.stop()
    if done["state"] != "successful":
        raise SystemExit(1)
    return outs


if __name__ == "__main__":
    main()
