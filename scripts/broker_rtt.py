#!/usr/bin/env python3
"""The signed round trip to the port's broker processes with their runtime
detectors off and on, in one run, so that the two can be compared.

    python3 scripts/broker_rtt.py [--requests 40] [--pairs 2]

Starts ``chip_smoke.py``'s broker process (``BROKER_SOURCE``, the indexed
``MemoryDatabase``) and its replicated broker (``HA_BROKER_SOURCE``, three
replicas behind Raft) once per mode, in the order off, on, on, off, ...
(``--pairs`` off/on pairs in all), with ``REPRO_LOCK_CHECK`` and
``REPRO_AUTH_CHECK`` set to 0 or 1 in the child's environment; in each, a
colony and ``--requests`` signed ``colonystats`` calls (to each replica
for the replicated broker) through the port's HTTP client, after five
unmeasured ones. Prints one line per process, and as its last line a JSON
object with each mode's round trips in ms. The broker is stdlib Python:
this measures the host, not the card.
"""

import argparse
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

MODES = {"off": {"REPRO_LOCK_CHECK": "0", "REPRO_AUTH_CHECK": "0"},
         "on": {"REPRO_LOCK_CHECK": "1", "REPRO_AUTH_CHECK": "1"}}


def single(mode: str, n: int) -> list[float]:
    from repro_torch.core.crypto import Crypto

    broker = cs.Broker()
    try:
        broker.client.add_colony(cs.COLONY, Crypto.id(broker.colony_prv), broker.server_prv)
        cs.signed_stats(broker, 5)
        _, seconds = cs.signed_stats(broker, n)
        if mode == "on":
            broker.report(f"[rtt {mode}]", ("shard", "glock"))
    finally:
        broker.close()
    return [s * 1e3 for s in seconds]


def replicated(mode: str, n: int) -> list[float]:
    from repro_torch.core.client import Colonies
    from repro_torch.core.crypto import Crypto

    ha = cs.HABroker()
    try:
        ha.client.add_colony(cs.COLONY, Crypto.id(ha.colony_prv), ha.server_prv)
        ms = []
        for port in ha.ports:
            client = Colonies(ha.transport([port]))
            for i in range(5 + n):
                t0 = time.perf_counter()
                client.stats(cs.COLONY, ha.colony_prv)
                if i >= 5:
                    ms.append((time.perf_counter() - t0) * 1e3)
        if mode == "on":
            ha.report(f"[ha rtt {mode}]", ("shard", "glock", "raft", "cluster"))
    finally:
        ha.close()
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--pairs", type=int, default=2, help="off/on pairs, run as off, on, on, off")
    args = ap.parse_args()
    order = (["off", "on", "on", "off"] * args.pairs)[:2 * args.pairs]
    if shutil.which("nvidia-smi"):  # the host's card, beside the numbers
        print(f"[card] {cs.smi('name,power.limit', units=True)}")
    out: dict[str, dict[str, list[float]]] = {"single": {"off": [], "on": []},
                                              "replicated": {"off": [], "on": []}}
    for mode in order:
        cs.DETECTOR_ENV = MODES[mode]
        for kind, fn in (("single", single), ("replicated", replicated)):
            ms = fn(mode, args.requests)
            out[kind][mode] += ms
            print(f"[rtt] {kind} broker, detectors {mode}: {len(ms)} signed colonystats, mean "
                  f"{statistics.fmean(ms):.3f} ms, median {statistics.median(ms):.3f} "
                  f"(min {min(ms):.3f}, max {max(ms):.3f})")
    summary = {kind: {mode: {"n": len(ms), "mean_ms": statistics.fmean(ms),
                             "median_ms": statistics.median(ms)}
                      for mode, ms in modes.items()} for kind, modes in out.items()}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
