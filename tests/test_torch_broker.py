"""The port's copy of the broker (``repro_torch.broker``) against the
reference's ``repro.core`` broker: one script of signed requests, sent by
the port's client to each, gets the same replies, once the random ids and
the timestamps are numbered in order of appearance. The script covers
colonies, executors, priority and targeted assignment, workflows with
their dataflow and failure propagation, dynamic children, exactly-once
replay, the failsafe, generators, CFS metadata and the error statuses.
Then the broker runs as the separate process ``chip_smoke.py`` starts,
over HTTP, and the port's executors complete a workflow on it."""

import json
import re
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from repro.core.cluster import standalone_server as ref_standalone_server
from repro_torch import trace
from repro_torch.broker import ColoniesHttpServer, standalone_server
from repro_torch.core import errors
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto, N
from repro_torch.core.http_transport import HttpTransport
from repro_torch.core.security import sign_envelope

ROOT = Path(__file__).resolve().parents[1]
HEX_ID = re.compile(r"\b[0-9a-f]{32}(?:[0-9a-f]{32})?\b")
RANDOM_IDS = {"processid", "workflowid", "generatorid", "fileid", "snapshotid"}
ID_LISTS = {"parents", "children", "fileids"}
TIMES = {"submissiontime", "starttime", "endtime", "deadline", "waitdeadline", "prioritytime",
         "commissiontime", "lastheardfrom", "added", "firstpack"}


def _key(seed: int) -> str:
    rng = np.random.default_rng(seed)
    while True:
        k = int.from_bytes(rng.bytes(32), "big")
        if 1 <= k < N:
            return k.to_bytes(32, "big").hex()


KEYS = {name: _key(seed) for seed, name in enumerate(
    ["server", "colony", "ex-a", "ex-b", "ex-e", "user", "stranger"], start=300)}


class _Numbering:
    """Replaces random ids by their order of appearance and timestamps by
    whether they are set, so two brokers' replies compare equal."""

    def __init__(self):
        self.ids: dict[str, str] = {}

    def id(self, value: str) -> str:
        return self.ids.setdefault(value, f"id{len(self.ids)}") if value else value

    def __call__(self, obj, key=None):
        if isinstance(obj, dict):
            return {k: self(v, k) for k, v in sorted(obj.items()) if k != "blob"}
        if isinstance(obj, list):
            if key in ID_LISTS:
                return [self.id(v) for v in obj]
            return [self(v) for v in obj]
        if key in RANDOM_IDS:
            return self.id(obj)
        if key in TIMES:
            return bool(obj)
        if isinstance(obj, str):  # ids quoted in messages
            return HEX_ID.sub(lambda m: self.id(m.group()), obj)
        return obj


def _spec(etype, funcname="fn", **kw):
    return dict({"conditions": {"colonyname": "dev", "executortype": etype},
                 "funcname": funcname}, **kw)


def _script(client: Colonies, srv) -> list:
    """The same requests for either broker; returns what each answered
    (a reply, or the error's class and status)."""
    log = []

    def call(fn, *args, **kwargs):
        try:
            log.append(fn(*args, **kwargs))
        except errors.ColoniesError as e:
            log.append({"error": type(e).__name__, "status": e.status})
        return log[-1]

    k, ident = KEYS, {n: Crypto.id(v) for n, v in KEYS.items()}
    colony = k["colony"]
    call(client.add_colony, "dev", ident["colony"], k["server"])
    call(client.add_colony, "dev", ident["colony"], k["server"])  # exists: 409
    call(client.add_colony, "other", ident["colony"], colony)  # not the server: 403
    for name, etype in (("ex-a", "h100-pod"), ("ex-b", "h100-pod"), ("ex-e", "edge-data")):
        call(client.add_executor, {"executorname": name, "executorid": ident[name],
                                   "colonyname": "dev", "executortype": etype}, colony)
    call(client.assign, "dev", 0.05, k["ex-a"])  # pending, not approved: 403
    for name in ("ex-a", "ex-b", "ex-e"):
        call(client.approve_executor, ident[name], colony)
    call(client.add_function, ident["ex-a"], "dev", "train", k["ex-a"])
    call(client.list_executors, "dev", colony)
    call(client.add_user, "dev", ident["user"], "alice", colony)
    call(client.list_users, "dev", k["user"])
    call(client.stats, "dev", k["stranger"])  # not a member: 403
    call(client.assign, "dev", 0.05, k["ex-a"])  # nothing queued: 408

    # priority (Eq. 1): the later submission with priority 1 goes first
    low = call(client.submit, _spec("h100-pod", args=["low"]), k["user"])
    high = call(client.submit, _spec("h100-pod", args=["high"], priority=1), colony)
    call(client.assign, "dev", 1.0, k["ex-a"])
    call(client.close, high["processid"], ["h"], k["ex-b"])  # not its owner: 409
    call(client.close, high["processid"], ["h"], k["ex-a"])
    call(client.close, high["processid"], ["h"], k["ex-a"])  # closed already: 409
    call(client.assign, "dev", 1.0, k["ex-b"])
    call(client.fail, low["processid"], ["boom"], k["ex-b"])
    # targeted: only the named executor gets it
    call(client.submit, _spec("h100-pod", conditions={
        "colonyname": "dev", "executortype": "h100-pod", "executornames": ["ex-b"]}), colony)
    call(client.assign, "dev", 0.05, k["ex-a"])
    tgt = call(client.assign, "dev", 1.0, k["ex-b"])
    call(client.close, tgt["processid"], [], k["ex-b"])

    # a workflow: prep -> train -> eval, outputs flowing to inputs
    wf = call(client.submit_workflow, {"colonyname": "dev", "functionspecs": [
        {"nodename": "prep", "funcname": "prepare_data",
         "conditions": {"executortype": "edge-data", "dependencies": []}},
        {"nodename": "train", "funcname": "train",
         "conditions": {"executortype": "h100-pod", "dependencies": ["prep"]}},
        {"nodename": "eval", "funcname": "evaluate",
         "conditions": {"executortype": "h100-pod", "dependencies": ["train"]}}]}, colony)
    call(client.assign, "dev", 0.05, k["ex-a"])  # train waits for prep: 408
    prep = call(client.assign, "dev", 1.0, k["ex-e"])
    call(client.close, prep["processid"], [1, 2], k["ex-e"])
    train = call(client.assign, "dev", 1.0, k["ex-a"])
    # a dynamic child that waits for its parent
    child = call(client.add_child, train["processid"], _spec("h100-pod", "child"), k["ex-a"],
                 waitforparent=True)
    call(client.add_child, train["processid"], _spec("h100-pod"), k["ex-b"])  # not its owner
    call(client.close, train["processid"], [3], k["ex-a"])
    ev = call(client.assign, "dev", 1.0, k["ex-b"])
    call(client.close, ev["processid"], [4], k["ex-b"])
    ch = call(client.assign, "dev", 1.0, k["ex-a"])
    call(client.close, ch["processid"], [], k["ex-a"])
    call(client.get_process, child["processid"], colony)
    call(client.get_process, wf["processes"][2]["processid"], colony)
    # a failed parent fails its descendants
    wf2 = call(client.submit_workflow, {"colonyname": "dev", "functionspecs": [
        {"nodename": "x", "conditions": {"executortype": "edge-data", "dependencies": []}},
        {"nodename": "y", "conditions": {"executortype": "h100-pod", "dependencies": ["x"]}}]},
        colony)
    x = call(client.assign, "dev", 1.0, k["ex-e"])
    call(client.fail, x["processid"], ["no data"], k["ex-e"])
    call(client.get_process, wf2["processes"][1]["processid"], colony)

    # exactly-once: a retried keyed request replays the first reply
    first = call(client._rpc, "submitfunctionspec", {"spec": _spec("nobody")}, colony,
                 msgid="ab" * 32)
    again = call(client._rpc, "submitfunctionspec", {"spec": _spec("nobody")}, colony,
                 msgid="ab" * 32)
    log.append(first == again)

    # the failsafe: a lease runs out (retry left, then none), a wait runs out
    call(client.submit, _spec("edge-data", "lease", maxexectime=1, maxretries=1), colony)
    call(client.submit, _spec("h100-pod", "last", maxexectime=1, maxretries=0), colony)
    call(client.submit, _spec("nobody", "stale", maxwaittime=1), colony)
    call(client.assign, "dev", 1.0, k["ex-e"])
    call(client.assign, "dev", 1.0, k["ex-a"])
    time.sleep(1.1)
    log.append(srv.failsafe_scan())
    call(client.assign, "dev", 1.0, k["ex-e"])  # the reset process, retries 1
    call(client.get_processes, "dev", colony, state="failed", count=50)

    # a generator: 3 packs at queuesize 2 fire one workflow with all 3
    g = call(client.add_generator, {"colonyname": "dev", "name": "gen", "queuesize": 2,
                                    "workflow": {"colonyname": "dev", "functionspecs": [
                                        {"nodename": "b", "funcname": "generate_batch",
                                         "conditions": {"executortype": "edge-data",
                                                        "dependencies": []}}]}}, colony)
    call(client.add_generator, {"colonyname": "dev", "workflow": {}}, colony)  # 400
    for arg in ("r1", "r2", "r3"):
        call(client.pack, g["generatorid"], {"request_id": arg}, k["user"])
    call(client.get_generators, "dev", colony)
    log.append([ext.tick() for ext in srv.extensions
                if type(ext).__name__ == "GeneratorExtension"])
    call(client.get_generators, "dev", colony)
    call(client.assign, "dev", 1.0, k["ex-e"])

    # CFS metadata: revisions, subtree listing, snapshot pins
    def add_file(label, name, data):
        return call(client.add_file, {"colonyname": "dev", "label": label, "name": name,
                                      "size": len(data), "checksum": f"c-{data}",
                                      "storage": {"backend": "mem", "url": f"mem://{data}"}},
                    colony)

    f1 = add_file("/in", "a.bin", "one")
    add_file("in/", "a.bin", "two")
    add_file("/in/sub", "b.bin", "three")
    add_file("/in", "../x", "bad")  # 400
    call(client.add_file, {"colonyname": "dev", "label": "/in", "name": "c", "checksum": "x"},
         colony)  # no storage: 400
    call(client.get_file, "dev", "/in", "a.bin", colony)
    call(client.get_file, "dev", "/in", "zzz", colony)  # 404
    call(client.get_files, "dev", "/in", colony)
    call(client.get_files, "dev", "/", colony)
    snap = call(client.create_snapshot, "dev", "/in", "s1", colony)
    call(client.get_snapshot, "dev", snap["snapshotid"], colony)
    call(client.get_snapshots, "dev", colony)
    call(client.remove_file, "dev", f1["fileid"], colony)  # not the head: removable
    call(client.get_file, "dev", "/in", "a.bin", colony)
    head = client.get_file("dev", "/in", "a.bin", colony)
    call(client.remove_file, "dev", head["fileid"], colony)  # pinned: 409
    call(client.remove_snapshot, "dev", snap["snapshotid"], colony)
    call(client.remove_file, "dev", head["fileid"], colony)
    call(client.remove_snapshot, "dev", snap["snapshotid"], colony)  # 404

    call(client.reject_executor, ident["ex-b"], colony)
    call(client.assign, "dev", 0.05, k["ex-b"])  # rejected: 403
    call(client.remove_executor, ident["ex-b"], colony)
    call(client.get_processes, "dev", colony, count=100)
    call(client.stats, "dev", colony)
    return log


def test_port_broker_answers_like_the_reference():
    server_id = Crypto.id(KEYS["server"])
    ours = standalone_server(server_id)
    theirs = ref_standalone_server(server_id)
    try:
        got = _script(Colonies(InProcTransport([ours])), ours)
        want = _script(Colonies(InProcTransport([theirs])), theirs)
    finally:
        ours.stop()
        theirs.stop()
    got, want = _Numbering()(got), _Numbering()(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"reply {i}: {json.dumps(a)} != {json.dumps(b)}"
    # the script reached what it set out to check
    assert got[-1]["successful"] >= 6 and got[-1]["failed"] >= 4
    assert {"error": "ConflictError", "status": 409} in got
    assert True in got  # the replayed submit


def test_port_broker_refuses_unsigned_and_unknown_requests():
    srv = standalone_server(Crypto.id(KEYS["server"]))
    env = {"payloadtype": "colonystats", "payload": "{}", "identity": "x"}
    assert srv.handle(env)["status"] == 403  # no signature
    client = Colonies(InProcTransport([srv]))
    with pytest.raises(errors.ValidationError):  # no handler for the payloadtype
        client._rpc("nosuchrequest", {"colonyname": "dev"}, KEYS["colony"])
    with pytest.raises(errors.NotFoundError):  # cron answers, as the reference's does
        client.get_crons("dev", KEYS["colony"])
    srv.stop()


def _post(port: int, body: bytes) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api", data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_port_broker_process_over_http():
    """The broker process of ``chip_smoke.py``: it imports neither torch nor
    the reference, verifies every signature, and answers over HTTP."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    broker = chip_smoke.Broker()
    try:
        assert broker.info["refuses_unsigned"] is True
        assert broker.info["torch_or_jax"] == [] and broker.info["reference"] == []
        transport = broker.transport
        assert transport.health()["status"] == "ok"
        colony_id = Crypto.id(broker.colony_prv)
        broker.client.add_colony("dev", colony_id, broker.server_prv)
        assert broker.client.stats("dev", broker.colony_prv)["waiting"] == 0
        port = transport.endpoints[0][1]
        env = sign_envelope("colonystats", {"colonyname": "dev"}, broker.colony_prv)
        env["payload"] = json.dumps({"colonyname": "dev", "x": 1})  # altered after signing
        status, body = _post(port, json.dumps(env).encode())
        assert status == 403 and "error" in body
        assert _post(port, b"{not json")[0] == 400
        assert broker.alive()
        # the process runs under the port's detectors and reports them
        rep = broker.report("[broker]", ("shard", "glock"))
        assert rep["lock_check"] and rep["auth_check"]
        assert rep["violations"] == [] and rep["contract_errors"] == []
        assert rep["holds"]["glock"][0] > 0 and rep["failsafe_errors"] == 0
        again = broker.report("[broker]")  # holds since the last report, and in all
        assert again["holds_total"]["glock"][0] == (rep["holds_total"]["glock"][0]
                                                    + again["holds"].get("glock", [0])[0])
    finally:
        broker.close()
    assert not broker.alive()


def test_port_executors_complete_a_workflow_on_the_port_broker(tmp_path):
    """prepare_data on the port's DataExecutor and a generator's batch on
    its ServeExecutor, both on the CPU, behind the port's broker over
    HTTP: the batch's greedy tokens equal the engine's own generate."""
    from repro_torch.core.fs import CFSClient, MemoryStorage
    from repro_torch.runtime import torch_executor as tx
    from repro_torch.serve.batcher import InferenceClient, pad_prompts

    server_prv, colony_prv = KEYS["server"], KEYS["colony"]
    srv = standalone_server(Crypto.id(server_prv))
    http = ColoniesHttpServer(srv)
    http.start()
    srv.start_background(failsafe_interval=0.05)
    client = Colonies(HttpTransport(http.host, http.port))
    storage = MemoryStorage()
    running = []
    try:
        client.add_colony("dev", Crypto.id(colony_prv), server_prv)
        kw = dict(colony_prvkey=colony_prv, device="cpu")
        data_ex = tx.DataExecutor(client, "dev", "edge-1", "edge-data", storage, **kw)
        serve_ex = tx.ServeExecutor(client, "dev", "serve-1", "h100-serve", storage,
                                    arch="stablelm-3b", max_len=32, **kw)
        before = trace.snapshot()["counters"]
        for ex in (data_ex, serve_ex):
            running.append(ex)
            ex.start(poll_timeout=0.2)
        p = client.submit({"conditions": {"colonyname": "dev", "executortype": "edge-data"},
                           "funcname": "prepare_data",
                           "kwargs": {"shards": 2, "tokens_per_shard": 64}}, colony_prv)
        done = client.wait(p["processid"], colony_prv, timeout=60)
        assert done["state"] == "successful", done["errors"]
        assert done["out"][0]["files"] == 2
        g = client.add_generator({"colonyname": "dev", "name": "g", "queuesize": 2,
                                  "timeout": 10.0, "workflow": {
                                      "colonyname": "dev", "functionspecs": [
                                          {"nodename": "batch", "funcname": "generate_batch",
                                           "conditions": {"executortype": "h100-serve",
                                                          "dependencies": []}}]}}, colony_prv)
        infc = InferenceClient(client, CFSClient(client, storage, colony_prv), "dev",
                               g["generatorid"], colony_prv)
        prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
        served = [infc.wait(r, timeout=60) for r in
                  [infc.submit(pr, max_new_tokens=4) for pr in prompts]]
    finally:
        for ex in running:
            ex.stop()
        http.stop()
        srv.stop()
    assert trace.counters_since(before)["serve.batches"] == 1 and data_ex.processed == 1
    direct = serve_ex.engine.generate(pad_prompts([{"prompt": pr} for pr in prompts]),
                                      max_new_tokens=4).tolist()
    assert served == direct
