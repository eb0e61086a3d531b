"""The clients of a serving cell, in a process of their own.

``python colonybench/clients.py <json>`` with the broker's port, the
colony, a member key, the generator, the blob store's directory, the
mix, the seed and the vocabulary. It loads the port's client modules
without torch, so its signing never takes the executor's interpreter
lock.

Each client submits a request as ``InferenceClient.submit`` does: a
signed ``pack`` to the generator. One poller lists the results label
(one signed ``getfiles``) every ``poll_s`` and hands each client its
result, read from the blob store; the client then submits its next
request at once (a closed loop). A request's latency runs from just
before its ``pack`` to the broker's record of its result file
(``added``), both on this host's clock, so it does not depend on the
polling.

Commands, one a line on stdin:

* ``wave <i> [<tokens>]``: every client sends its request of wave ``i``,
  asking for ``tokens`` where given; answers once all are published (the
  warm-up is wave 0).
* ``go <end>``: the closed loop from wave 1 until ``end`` (``time.time()``);
  then only the requests that fill the last wave sent before ``end`` go
  out, and once every request sent before ``end`` is published (or
  ``grace_s`` later) the window's records are written to ``out`` and
  ``{"done": ...}`` is printed.

The process ends when its stdin closes.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from colonybench.broker import register_package  # noqa: E402
from colonybench.traffic.requests import wave  # noqa: E402


class Clients:
    def __init__(self, cfg: dict) -> None:
        register_package(Path(cfg["src"]))
        from repro_torch.core.client import Colonies
        from repro_torch.core.fs import LocalStorage
        from repro_torch.core.http_transport import HttpTransport

        self.cfg = cfg
        self.client = Colonies(HttpTransport("127.0.0.1", cfg["port"]))
        self.storage = LocalStorage(cfg["blobs"])
        self.mix, self.seed, self.vocab = cfg["mix"], cfg["seed"], cfg["vocab"]
        self.n = self.mix["clients"]
        self.records: list[dict] = []  # one per request sent
        self.spans: list[list] = []  # [kind, start (time.time()), seconds]
        self.waves: dict[int, list[dict]] = {}
        self.seen: set[str] = set()

    def _rpc(self, kind: str, fn, *args):
        t0 = time.time()
        out = fn(*args)
        self.spans.append([kind, t0, time.time() - t0])
        return out

    def send(self, client: int, index: int, max_new: int | None = None) -> dict:
        if index not in self.waves:
            self.waves[index] = wave(self.mix, self.seed, index, self.vocab)
        req = self.waves[index][client]
        rid = f"w{index}c{client}s{self.seed}"
        rec = {"rid": rid, "client": client, "wave": index, "prompt_len": len(req["prompt"]),
               "max_new_tokens": max_new or req["max_new_tokens"], "sent": time.time()}
        self._rpc("pack", self.client.pack, self.cfg["generatorid"],
                  {"request_id": rid, "prompt": req["prompt"],
                   "max_new_tokens": rec["max_new_tokens"]}, self.cfg["prvkey"])
        self.records.append(rec)
        return rec

    def poll(self, pending: dict[str, dict]) -> list[dict]:
        """The records of ``pending`` whose results are now published."""
        files = self._rpc("getfiles", self.client.get_files, self.cfg["colony"], "/results",
                          self.cfg["prvkey"])
        done = []
        for f in files:
            rid = f["name"][: -len(".json")]
            if rid in pending and rid not in self.seen:
                self.seen.add(rid)
                rec = pending.pop(rid)
                rec["published"] = f["added"] / 1e9
                rec["seen"] = time.time()
                data = json.loads(self.storage.get(f["storage"]["url"]))
                rec["tokens"] = data["tokens"][: rec["max_new_tokens"]]
                rec["all_tokens"] = data["tokens"]  # the batch's largest ask
                done.append(rec)
        return done

    def send_wave(self, index: int, max_new: int | None = None) -> dict:
        """Every client sends its request of wave ``index`` (asking for
        ``max_new`` tokens where given); returns once all are published."""
        t0 = time.time()
        pending = {r["rid"]: r for r in (self.send(c, index, max_new) for c in range(self.n))}
        while pending:
            time.sleep(self.cfg["poll_s"])
            self.poll(pending)
        return {"wave": index, "seconds": time.time() - t0}

    def loop(self, end: float) -> dict:
        first = len(self.records)
        pending = {}
        for c in range(self.n):
            rec = self.send(c, 1)
            pending[rec["rid"]] = rec
        last_wave = 1
        deadline = end + self.cfg["grace_s"]
        while time.time() < deadline:
            time.sleep(self.cfg["poll_s"])
            for rec in self.poll(pending):
                nxt = rec["wave"] + 1
                if time.time() < end:
                    last_wave = max(last_wave, nxt)
                elif nxt > last_wave:
                    continue  # nothing in the window waits for this wave
                new = self.send(rec["client"], nxt)
                pending[new["rid"]] = new
            if time.time() >= end and not any(r["sent"] < end for r in pending.values()):
                break
        records = self.records[first:]
        with open(self.cfg["out"], "w") as f:
            json.dump({"records": records, "spans": self.spans}, f)
        unfinished = sum(1 for r in pending.values() if r["sent"] < end)
        return {"done": len(records), "unfinished": unfinished,
                "last_wave": max(r["wave"] for r in records)}


def main() -> None:
    clients = Clients(json.loads(sys.argv[1]))
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        cmd = line.split()
        if cmd and cmd[0] == "wave":
            out = clients.send_wave(int(cmd[1]), int(cmd[2]) if len(cmd) > 2 else None)
        elif cmd and cmd[0] == "go":
            out = clients.loop(float(cmd[1]))
        else:
            out = {"error": f"unknown command {line.strip()!r}"}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
