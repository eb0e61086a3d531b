"""The port's copy of the client side of ColonyOS (``repro_torch.core``)
against the reference's ``repro.core``: the same identities and signature
bits, byte-equal envelopes, the same idempotency classes, spec and
process round trips, the same retry delays, and the port's SDK client
driving the reference's broker (signatures verified) in process and over
HTTP."""

import json

import numpy as np
import pytest

from repro.core import crypto as ref_crypto
from repro.core import idempotency as ref_idem
from repro.core import process as ref_process
from repro.core import retry as ref_retry
from repro.core import security as ref_security
from repro.core import spec as ref_spec
from repro.core.cluster import standalone_server
from repro.core.errors import ValidationError as RefValidationError
from repro.core.http_transport import ColoniesHttpServer
from repro_torch.core import crypto, errors, idempotency, process, retry, security, spec
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.fs import CFSClient, LocalStorage, MemoryStorage
from repro_torch.core.http_transport import HttpTransport

MESSAGES = ["", "assign", json.dumps({"spec": {"funcname": "train"}}), "ü" * 70]


def _key(seed: int) -> str:
    """A private key from ``seed``, in [1, N)."""
    rng = np.random.default_rng(seed)
    while True:
        k = int.from_bytes(rng.bytes(32), "big")
        if 1 <= k < crypto.N:
            return k.to_bytes(32, "big").hex()


@pytest.mark.parametrize("seed", range(20))
def test_crypto_ids_and_signatures_equal_the_reference(seed):
    prv = _key(seed)
    assert crypto.Crypto.id(prv) == ref_crypto.Crypto.id(prv)
    msg = MESSAGES[seed % len(MESSAGES)] + str(seed)
    ours, theirs = crypto.Crypto.sign(msg, prv), ref_crypto.Crypto.sign(msg, prv)
    assert ours == theirs and len(bytes.fromhex(ours)) == 65
    # each side recovers the other's signature to the signer's identity
    ident = ref_crypto.Crypto.id(prv)
    assert ref_crypto.Crypto.recover(msg, ours) == ident
    assert crypto.Crypto.recover(msg, theirs) == ident
    assert not crypto.Crypto.verify(msg + "x", theirs, ident)


def test_fresh_keys_are_valid_for_the_reference():
    prv = crypto.Crypto.prvkey()
    assert 1 <= int(prv, 16) < ref_crypto.N
    assert ref_crypto.Crypto.verify("m", crypto.Crypto.sign("m", prv), crypto.Crypto.id(prv))


@pytest.mark.parametrize("msgid", [None, "", "ab" * 32])
def test_signed_envelopes_are_byte_equal(msgid):
    prv = _key(100)
    payload = {"spec": {"funcname": "train", "kwargs": {"steps": 4, "arch": "stablelm-3b"}},
               "z": [1, 2.5, None], "a": "ü"}
    assert security.canonical(payload) == ref_security.canonical(payload)
    ours = security.sign_envelope("submitfunctionspec", payload, prv, msgid=msgid)
    theirs = ref_security.sign_envelope("submitfunctionspec", payload, prv, msgid=msgid)
    assert json.dumps(ours) == json.dumps(theirs)
    ident, ptype, opened = ref_security.open_envelope(ours)
    assert (ident, ptype, opened) == (crypto.Crypto.id(prv), "submitfunctionspec", payload)


def test_idempotency_classes_equal_the_reference():
    assert idempotency.SPEC == ref_idem.SPEC
    for ptype in list(ref_idem.SPEC) + ["nosuchpayload"]:
        assert idempotency.classify(ptype) == ref_idem.classify(ptype), ptype


CONTINUUM_WF = {
    "colonyname": "dev",
    "functionspecs": [
        {"nodename": "prep", "funcname": "prepare_data",
         "kwargs": {"shards": 2, "tokens_per_shard": 256},
         "conditions": {"executortype": "edge-data", "dependencies": []}, "maxexectime": 30},
        {"nodename": "train", "funcname": "train",
         "kwargs": {"arch": "stablelm-3b", "steps": 4, "batch": 2, "seq_len": 16,
                    "checkpoint_every": 1, "run": "itest"},
         "conditions": {"executortype": "h100-pod", "dependencies": ["prep"]},
         "maxexectime": 60, "maxretries": 5},
        {"nodename": "eval", "funcname": "evaluate",
         "kwargs": {"arch": "stablelm-3b", "batch": 2, "seq_len": 16, "run": "itest"},
         "conditions": {"executortype": "h100-pod", "dependencies": ["train"]},
         "maxexectime": 30},
    ],
}
SPECS = [
    {"conditions": {"colonyname": "dev", "executortype": "h100-pod"}, "funcname": "train",
     "kwargs": {"arch": "stablelm-3b", "steps": 4, "batch": 2, "seq_len": 16,
                "checkpoint_every": 2, "run": "handoff"}, "maxexectime": 60},
    {"conditions": {"colonyname": "dev", "executortype": "h100-serve", "executornames": ["s1"],
                    "gpu": {"count": 1, "name": "h100"}, "processes-per-node": 2},
     "funcname": "generate_batch", "priority": 3, "env": {"A": "1"}, "label": "l",
     "kwargs": {"packed_args": [{"request_id": "r0", "prompt": [1, 2], "max_new_tokens": 4}]}},
    {"conditions": {"colonyname": "dev", "executortype": "fsw"}, "funcname": "consume",
     "maxexectime": 30,
     "fs": {"mount": "/cfs",
            "snapshots": [{"snapshotid": "s1", "label": "/in", "dir": "/cfs/in",
                           "keepsnaphot": True}],
            "dirs": [{"label": "/out", "dir": "/cfs/out", "upload": True, "keepfiles": False}]}},
]


@pytest.mark.parametrize("case", range(len(SPECS)))
def test_function_spec_round_trips_equal_the_reference(case):
    d = SPECS[case]
    ours = spec.FunctionSpec.from_dict(d)
    assert ours.to_dict() == ref_spec.FunctionSpec.from_dict(d).to_dict()
    assert ours.to_json() == ref_spec.FunctionSpec.from_json(ours.to_json()).to_json()


def test_workflow_spec_round_trips_and_validates_like_the_reference():
    ours = spec.WorkflowSpec.from_dict(CONTINUUM_WF)
    assert ours.to_dict() == ref_spec.WorkflowSpec.from_dict(CONTINUUM_WF).to_dict()
    ours.validate()
    bad = json.loads(json.dumps(CONTINUUM_WF))
    bad["functionspecs"][0]["conditions"]["dependencies"] = ["eval"]  # a cycle
    with pytest.raises(errors.ValidationError, match="cycle"):
        spec.WorkflowSpec.from_dict(bad).validate()
    with pytest.raises(RefValidationError, match="cycle"):
        ref_spec.WorkflowSpec.from_dict(bad).validate()


def test_retry_delays_and_outcomes_equal_the_reference():
    kw = dict(base_s=0.001, cap_s=0.01, deadline_s=5.0, budget=8, seed=7)
    ours, theirs = retry.RetryPolicy(**kw).delays(), ref_retry.RetryPolicy(**kw).delays()
    assert [ours.next_delay() for _ in range(30)] == [theirs.next_delay() for _ in range(30)]

    def flaky(n):
        calls = []

        def attempt():
            calls.append(1)
            return {"error": "down", "status": 503} if len(calls) <= n else {"result": len(calls)}
        return attempt, calls

    for n in (0, 3, 20):
        a, ca = flaky(n)
        b, cb = flaky(n)
        assert (retry.send_with_retry(a, retry.RetryPolicy(**kw))
                == ref_retry.send_with_retry(b, ref_retry.RetryPolicy(**kw)))
        assert len(ca) == len(cb)


@pytest.fixture()
def broker(server_keys, colony_keys):
    """The reference's broker (signatures verified) with a 'dev' colony
    created through the port's client."""
    server_prv, server_id = server_keys
    colony_prv, colony_id = colony_keys
    srv = standalone_server(server_id)
    client = Colonies(InProcTransport([srv]))
    client.add_colony("dev", colony_id, server_prv)
    yield srv, client, colony_prv
    srv.stop()


def test_port_client_drives_the_reference_broker(broker):
    srv, client, colony_prv = broker
    assert srv.verify_signatures
    ex_prv = crypto.Crypto.prvkey()
    ex_id = crypto.Crypto.id(ex_prv)
    client.add_executor({"executorname": "w1", "executorid": ex_id, "colonyname": "dev",
                         "executortype": "h100-pod"}, colony_prv)
    client.approve_executor(ex_id, colony_prv)
    assert [e["executorid"] for e in client.list_executors("dev", colony_prv)] == [ex_id]
    client.add_function(ex_id, "dev", "train", ex_prv)
    p = client.submit(spec.FunctionSpec.from_dict(SPECS[0]), colony_prv)
    a = client.assign("dev", 2.0, ex_prv)
    assert a["processid"] == p["processid"]
    assigned = process.Process.from_dict(a)
    assert assigned.to_dict() == ref_process.Process.from_dict(a).to_dict()
    assert assigned.state == process.RUNNING and assigned.spec.funcname == "train"
    with pytest.raises(errors.TimeoutError_):
        client.assign("dev", 0.1, ex_prv)
    closed = client.close(p["processid"], [{"final_step": 3}], ex_prv)
    assert closed["state"] == "successful"
    with pytest.raises(errors.ConflictError):
        client.close(p["processid"], [], ex_prv)
    with pytest.raises(errors.AuthError):  # not a member of the colony
        client.submit(SPECS[0], crypto.Crypto.prvkey())
    stats = client.stats("dev", colony_prv)
    assert stats["successful"] == 1 and stats["waiting"] == 0
    assert client.wait(p["processid"], colony_prv, timeout=5)["out"] == [{"final_step": 3}]
    wf = client.submit_workflow(spec.WorkflowSpec.from_dict(CONTINUUM_WF), colony_prv)
    assert [q["spec"]["nodename"] for q in wf["processes"]] == ["prep", "train", "eval"]


@pytest.mark.parametrize("storage", ["memory", "local"])
def test_port_cfs_client_files_and_snapshots(broker, storage, tmp_path):
    _, client, colony_prv = broker
    store = MemoryStorage() if storage == "memory" else LocalStorage(str(tmp_path / "blobs"))
    cfs = CFSClient(client, store, colony_prv)
    cfs.upload_bytes("dev", "/in", "a.bin", b"first")
    snap = client.create_snapshot("dev", "/in", "s1", colony_prv)
    cfs.upload_bytes("dev", "/in", "a.bin", b"second")  # a new revision; the snapshot pins the old
    cfs.upload_bytes("dev", "/in/sub", "b.bin", b"deep")
    assert cfs.download_bytes("dev", "/in", "a.bin") == b"second"
    assert sorted(f["name"] for f in client.get_files("dev", "/in", colony_prv)) == ["a.bin",
                                                                                   "b.bin"]
    assert client.get_snapshot("dev", snap["snapshotid"], colony_prv)["name"] == "s1"
    got = cfs.materialize_snapshot("dev", snap["snapshotid"], str(tmp_path / "snap"))
    assert [open(p, "rb").read() for p in got] == [b"first"]
    down = cfs.sync_down("dev", "/in", str(tmp_path / "down"))
    assert sorted(open(p, "rb").read() for p in down) == [b"deep", b"second"]
    assert (tmp_path / "down" / "sub" / "b.bin").read_bytes() == b"deep"
    (tmp_path / "up" / "d").mkdir(parents=True)
    (tmp_path / "up" / "d" / "c.txt").write_bytes(b"up")
    cfs.sync_up("dev", "/out", str(tmp_path / "up"))
    assert cfs.download_bytes("dev", "/out/d", "c.txt") == b"up"
    with pytest.raises(errors.NotFoundError):
        cfs.download_bytes("dev", "/in", "missing.bin")
    with pytest.raises(errors.ValidationError):
        CFSClient._safe_dest(str(tmp_path), "", "..")
    assert [s["snapshotid"] for s in client.get_snapshots("dev", colony_prv)] == [snap["snapshotid"]]
    client.remove_snapshot("dev", snap["snapshotid"], colony_prv)
    assert client.get_snapshots("dev", colony_prv) == []


def test_port_http_transport_against_the_reference_http_broker(server_keys, colony_keys):
    server_prv, server_id = server_keys
    colony_prv, colony_id = colony_keys
    srv = standalone_server(server_id)
    http = ColoniesHttpServer(srv)
    http.start()
    try:
        transport = HttpTransport(http.host, http.port)
        assert transport.health()["status"] == "ok"
        client = Colonies(transport)
        client.add_colony("dev", colony_id, server_prv)
        p = client.submit(SPECS[0], colony_prv)
        assert client.get_process(p["processid"], colony_prv)["state"] == "waiting"
        assert client.stats("dev", colony_prv)["waiting"] == 1
        with pytest.raises(errors.AuthError):  # the broker verified and refused
            Colonies(transport).add_colony("other", colony_id, colony_prv)
    finally:
        http.stop()
        srv.stop()
    # a broker that is gone is a retryable transport failure
    with pytest.raises(errors.TransportError):
        Colonies(HttpTransport(http.host, http.port)).stats("dev", colony_prv)
