"""The port's broker over a ``SqliteDatabase`` file (paper §3.4.3: no
session state lives in the broker's memory).

A file written by the reference's broker opens in the port's broker and
gives the same replies as in the reference's own, and the other way round:
the queue, colonystats, CFS metadata, cron, a generator's pending packs and
a dedup replay. The port's copies of the reference's restart tests; the
broker process of ``chip_smoke.py`` SIGKILLed and restarted over its file;
and one test for each fault the indexed and sqlite databases brought to
light in the port's broker: the failsafe on a stale copy (F1), the dedup
table's per-colony bound (F2), the requeue of released and reset
processes (F3) and the generator's packs in the reference's table (F4)."""

import shutil
import sys
import time

import pytest

from repro.core.cluster import standalone_server as ref_standalone_server
from repro.core.database import SqliteDatabase as RefSqliteDatabase
from repro_torch.broker import MemoryDatabase, SqliteDatabase, standalone_server
from repro_torch.broker import database as port_database
from repro_torch.broker.generator import PACKS_TABLE
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.executor import ExecutorBase
from repro_torch.core.process import RUNNING, SUCCESSFUL, WAITING, Process, new_id, now_ns
from repro_torch.core.security import sign_envelope
from repro_torch.core.spec import FunctionSpec
from test_torch_broker import KEYS, ROOT, _Numbering

IDS = {n: Crypto.id(v) for n, v in KEYS.items()}
SERVERS = {"port": (standalone_server, SqliteDatabase),
           "ref": (ref_standalone_server, RefSqliteDatabase)}
WF = {"colonyname": "dev", "functionspecs": [
    {"nodename": "batch", "funcname": "generate_batch",
     "conditions": {"executortype": "h100-serve", "dependencies": []}}]}


def _spec(etype, **kw):
    return dict({"conditions": {"colonyname": "dev", "executortype": etype},
                 "funcname": "fn"}, **kw)


def _open(pkg: str, path: str):
    make_server, make_db = SERVERS[pkg]
    srv = make_server(IDS["server"], make_db(path))
    return srv, Colonies(InProcTransport([srv]))


def _write(pkg: str, path: str) -> dict:
    """A broker of ``pkg`` writes its file: a colony, two executors, three
    queued processes (one running, one targeted), CFS revisions and a
    snapshot, a cron, a generator with two pending packs and a keyed
    submit whose envelope is kept for a replay."""
    srv, client = _open(pkg, path)
    colony = KEYS["colony"]
    client.add_colony("dev", IDS["colony"], KEYS["server"])
    for name in ("ex-a", "ex-b"):
        client.add_executor({"executorname": name, "executorid": IDS[name], "colonyname": "dev",
                             "executortype": "h100-pod"}, colony)
        client.approve_executor(IDS[name], colony)
    client.submit(_spec("h100-pod", args=["low"]), colony)
    client.submit(_spec("h100-pod", args=["high"], priority=1, maxexectime=600), colony)
    client.submit(dict(_spec("h100-pod", args=["for-b"]),
                       conditions={"colonyname": "dev", "executortype": "h100-pod",
                                   "executornames": ["ex-b"]}), colony)
    client.assign("dev", 1.0, KEYS["ex-a"])  # "high": running, its lease in the file
    for i, (label, name) in enumerate([("/data", "x.npy"), ("/data", "x.npy"),
                                       ("/data/sub", "y.npy")]):
        client.add_file({"colonyname": "dev", "label": label, "name": name, "size": i,
                         "checksum": f"{i:064x}",
                         "storage": {"backend": "mem", "url": f"mem://{i}"}}, colony)
    snap = client.create_snapshot("dev", "/data", "v1", colony)
    client.add_cron({"colonyname": "dev", "name": "nightly", "interval": 3600.0,
                     "workflow": WF}, colony)
    g = client.add_generator({"colonyname": "dev", "name": "gen", "queuesize": 3,
                              "workflow": WF}, colony)
    client.pack(g["generatorid"], {"request_id": "r0"}, colony)
    client.pack(g["generatorid"], {"request_id": "r1"}, colony)
    env = sign_envelope("submitfunctionspec", {"spec": _spec("nobody")}, colony, msgid="ab" * 32)
    first = srv.handle(env)
    assert "result" in first
    srv.stop()
    srv.db._conn.close()  # the WAL folds into the file
    return {"env": env, "first": first, "generatorid": g["generatorid"],
            "snapshotid": snap["snapshotid"]}


def _read(pkg: str, path: str, written: dict) -> list:
    """A broker of ``pkg`` over the file: what it answers."""
    srv, client = _open(pkg, path)
    colony = KEYS["colony"]
    log = [client.stats("dev", colony),
           client.get_processes("dev", colony, count=100),
           client.list_executors("dev", colony),
           client.get_files("dev", "/", colony),
           client.get_file("dev", "/data", "x.npy", colony),
           client.get_snapshot("dev", written["snapshotid"], colony),
           client.get_crons("dev", colony),
           client.get_generators("dev", colony)]
    replay = srv.handle(written["env"])
    log.append(replay.get("replayed"))
    log.append(replay["result"] == written["first"]["result"])
    log.append(client.assign("dev", 1.0, KEYS["ex-a"]))  # "low": "for-b" is not ex-a's
    log.append(client.assign("dev", 1.0, KEYS["ex-b"]))  # "for-b"
    client.pack(written["generatorid"], {"request_id": "r2"}, colony)
    log.append(srv.extensions[1].tick())  # the third pack fires the generator
    batch = [p for p in client.get_processes("dev", colony, state="waiting", count=100)
             if p["spec"]["funcname"] == "generate_batch"]
    log.append([p["spec"]["kwargs"]["packed_args"] for p in batch])
    log.append(client.get_generators("dev", colony))
    log.append(client.stats("dev", colony))
    srv.stop()
    srv.db._conn.close()
    return _Numbering()(log)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_file_opens_in_the_other_package_with_the_same_replies(writer, tmp_path):
    path = tmp_path / "written.db"
    written = _write(writer, str(path))
    replies = {}
    for reader in ("port", "ref"):
        copy = tmp_path / f"{reader}.db"
        shutil.copy(path, copy)
        replies[reader] = _read(reader, str(copy), written)
    assert replies["port"] == replies["ref"]
    got = replies["port"]
    assert got[0]["waiting"] == 3 and got[0]["running"] == 1  # the queue and its counters
    assert got[7][0]["pending"] == 2  # the pending packs survived
    assert got[8] is True and got[9] is True  # the dedup record replayed the submit
    assert got[10]["spec"]["args"] == ["low"] and got[11]["spec"]["args"] == ["for-b"]
    assert got[12] == 1
    assert got[13] == [[{"request_id": "r0"}, {"request_id": "r1"}, {"request_id": "r2"}]]


def test_queue_survives_server_restart(tmp_path):
    """``tests/test_system.py``'s, on the port: a new broker over the same
    file resumes where the old one stopped."""
    server_prv, colony_prv = KEYS["server"], KEYS["colony"]
    path = str(tmp_path / "colonies.db")
    srv1 = standalone_server(IDS["server"], SqliteDatabase(path))
    client1 = Colonies(InProcTransport([srv1]))
    client1.add_colony("dev", IDS["colony"], server_prv)
    ex = ExecutorBase(client1, "dev", "w1", "worker", colony_prvkey=colony_prv)
    p = client1.submit(FunctionSpec.from_dict({
        "conditions": {"colonyname": "dev", "executortype": "worker"},
        "funcname": "echo", "args": ["persisted"]}), colony_prv)
    srv1.stop()
    del srv1

    srv2 = standalone_server(IDS["server"], SqliteDatabase(path))
    client2 = Colonies(InProcTransport([srv2]))
    pd = client2.assign("dev", 2.0, ex.prvkey)
    assert pd["processid"] == p["processid"]
    client2.close(pd["processid"], ["done-after-restart"], ex.prvkey)
    done = client2.get_process(p["processid"], colony_prv)
    assert done["state"] == "successful" and done["out"] == ["done-after-restart"]
    srv2.stop()


def test_sqlite_dedup_survives_restart(tmp_path):
    """``tests/test_faults.py``'s, on the port: a keyed request replayed
    against a restarted broker over the same file gets the recorded reply."""
    path = str(tmp_path / "colonies.db")
    srv = standalone_server(IDS["server"], SqliteDatabase(path))
    client = Colonies(InProcTransport([srv]))
    client.add_colony("dev", IDS["colony"], KEYS["server"])
    client.add_executor({"executorname": "e1", "executorid": IDS["ex-a"], "colonyname": "dev",
                         "executortype": "cli"}, KEYS["colony"])
    client.approve_executor(IDS["ex-a"], KEYS["colony"])
    env = sign_envelope("submitfunctionspec", {"spec": _spec("cli")}, KEYS["ex-a"],
                        msgid=new_id())
    r1 = srv.handle(env)
    assert "result" in r1 and r1.get("replayed") is None
    srv.stop()

    srv2 = standalone_server(IDS["server"], SqliteDatabase(path))
    try:
        r2 = srv2.handle(env)
        assert r2.get("replayed") is True
        assert r2["result"]["processid"] == r1["result"]["processid"]
        procs = Colonies(InProcTransport([srv2])).get_processes("dev", KEYS["ex-a"])
        assert [p["processid"] for p in procs] == [r1["result"]["processid"]]
    finally:
        srv2.stop()


def test_broker_process_killed_and_restarted_over_its_file(tmp_path):
    """``chip_smoke.py``'s broker process over a sqlite file: SIGKILL, a
    restart on the same port, and the queue, a lease and the counters as
    they were; the restarted process loads neither torch nor the reference."""
    from repro_torch.core.retry import RetryPolicy

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    broker = chip_smoke.Broker(str(tmp_path / "colonies.db"),
                               retry=RetryPolicy(**chip_smoke.DURABLE_RETRY_KW))
    try:
        assert broker.info["db"] == "SqliteDatabase"
        client, colony = broker.client, broker.colony_prv
        client.add_colony("dev", Crypto.id(colony), broker.server_prv)
        exec_prv = Crypto.prvkey()
        client.add_executor({"executorname": "w", "executorid": Crypto.id(exec_prv),
                             "colonyname": "dev", "executortype": "worker"}, colony)
        client.approve_executor(Crypto.id(exec_prv), colony)
        running = client.submit(_spec("worker", maxexectime=600), colony)
        client.assign("dev", 1.0, exec_prv)
        queued = client.submit(_spec("worker"), colony)
        port, before = broker.port, client.stats("dev", colony)
        broker.kill("[durable]", chip_smoke.SQLITE_FAMILIES)  # reads the detectors' report
        assert not broker.alive()
        restart_s = broker.restart()
        assert broker.alive() and broker.port == port and 0 < restart_s < 30
        assert broker.info["torch_or_jax"] == [] and broker.info["reference"] == []
        assert client.stats("dev", colony) == before
        lease = client.get_process(running["processid"], colony)
        assert lease["state"] == "running" and lease["deadline"] > now_ns()
        assert client.assign("dev", 1.0, exec_prv)["processid"] == queued["processid"]
        client.close(running["processid"], ["ok"], exec_prv)
        assert client.stats("dev", colony)["successful"] == 1
        rep = broker.report("[durable]", ("sqlite", "dbcolony"))
        assert rep["violations"] == [] and rep["holds_total"]["sqlite"][0] > 0
    finally:
        broker.close()
    assert not broker.alive()


# ---------------------------------------------------------------------------
# F1-F4
# ---------------------------------------------------------------------------


def _proc(state, **kw):
    p = Process.create(FunctionSpec.from_dict(_spec("worker", **kw)))
    p.state = state
    return p


class _StaleScanDatabase(MemoryDatabase):
    """Its deadline scans hand back copies, as a sqlite database does, and
    the process changes between the index read and the failsafe's lock: a
    running one closes, a waiting one is assigned."""

    def running_past_deadline(self, ts):
        found = [Process.from_dict(p.to_dict()) for p in super().running_past_deadline(ts)]
        for p in found:
            live = self.get_process(p.processid)
            live.state, live.deadline_ns = SUCCESSFUL, 0
            self.update_process(live)
        return found

    def waiting_past_deadline(self, ts):
        found = [Process.from_dict(p.to_dict()) for p in super().waiting_past_deadline(ts)]
        for p in found:
            live = self.get_process(p.processid)
            live.state, live.assignedexecutorid = RUNNING, "e1"
            self.update_process(live)
        return found


def test_f1_failsafe_rereads_under_the_lock():
    db = _StaleScanDatabase()
    srv = standalone_server(IDS["server"], db)
    closed, assigned = _proc(RUNNING, maxretries=3), _proc(WAITING)
    closed.deadline_ns = assigned.waitdeadline_ns = now_ns() - 10**9
    db.add_process(closed)
    db.add_process(assigned)
    assert srv.failsafe_scan() == {"reset": 0, "failed": 0, "waitexpired": 0}
    assert db.get_process(closed.processid).state == SUCCESSFUL  # not reset to waiting
    assert db.get_process(closed.processid).retries == 0
    assert db.get_process(assigned.processid).state == RUNNING  # not failed
    assert db.colony_stats("dev") == {SUCCESSFUL: 1, RUNNING: 1}
    srv.stop()


def test_f2_dedup_is_bounded_per_colony(tmp_path):
    """A busy colony's records never evict a quiet colony's; the server
    files each keyed reply under its colony."""
    cap = port_database.DEDUP_MAX_PER_COLONY
    for db in (MemoryDatabase(), SqliteDatabase(str(tmp_path / "d.db"))):
        ts = now_ns()
        db.dedup_put("quiet:0", "quiet", ts, {"n": 0})
        for i in range(cap + 256):
            db.dedup_put(f"busy:{i}", "busy", ts + i + 1, {"n": i})
        assert db.dedup_get("quiet:0") == {"n": 0}
        assert db.dedup_get("busy:0") is None and db.dedup_get(f"busy:{cap + 255}") == {
            "n": cap + 255}
    db = MemoryDatabase()
    srv = standalone_server(IDS["server"], db)
    client = Colonies(InProcTransport([srv]))
    client.add_colony("dev", IDS["colony"], KEYS["server"])
    client.submit(_spec("worker"), KEYS["colony"])
    assert sorted({colony for _, colony, _ in db._dedup.values()}) == ["dev"]
    srv.stop()


class _CountingDatabase(MemoryDatabase):
    def __init__(self):
        super().__init__()
        self.requeued: list[str] = []

    def requeue(self, p):
        self.requeued.append(p.processid)
        super().requeue(p)


def test_f3_released_and_reset_processes_are_requeued():
    db = _CountingDatabase()
    srv = standalone_server(IDS["server"], db)
    client = Colonies(InProcTransport([srv]))
    colony = KEYS["colony"]
    client.add_colony("dev", IDS["colony"], KEYS["server"])
    client.add_executor({"executorname": "w", "executorid": IDS["ex-a"], "colonyname": "dev",
                         "executortype": "worker"}, colony)
    client.approve_executor(IDS["ex-a"], colony)
    wf = client.submit_workflow({"colonyname": "dev", "functionspecs": [
        {"nodename": "a", "funcname": "fn", "maxexectime": 1,
         "conditions": {"executortype": "worker", "dependencies": []}, "maxretries": 2},
        {"nodename": "b", "funcname": "fn",
         "conditions": {"executortype": "worker", "dependencies": ["a"]}}]}, colony)
    a, b = (p["processid"] for p in wf["processes"])
    assert client.assign("dev", 1.0, KEYS["ex-a"])["processid"] == a
    time.sleep(1.1)
    assert srv.failsafe_scan()["reset"] == 1  # a's lease ran out: back to the queue
    assert db.requeued == [a]
    assert client.assign("dev", 1.0, KEYS["ex-a"])["processid"] == a
    client.close(a, ["x"], KEYS["ex-a"])  # releases b
    assert db.requeued == [a, b]
    assert client.assign("dev", 1.0, KEYS["ex-a"])["processid"] == b
    srv.stop()


def test_f4_generator_packs_live_in_the_reference_table(tmp_path):
    """The pending packs are the list bucket ``generator_packs`` of the
    database, as the reference's generator keeps them, so a file carries
    them from either package's broker to the other's."""
    assert PACKS_TABLE == "generator_packs"
    path = str(tmp_path / "g.db")
    db = SqliteDatabase(path)
    srv = standalone_server(IDS["server"], db)
    client = Colonies(InProcTransport([srv]))
    client.add_colony("dev", IDS["colony"], KEYS["server"])
    g = client.add_generator({"colonyname": "dev", "name": "g", "queuesize": 3,
                              "workflow": WF}, KEYS["colony"])
    client.pack(g["generatorid"], "p0", KEYS["colony"])
    client.pack(g["generatorid"], "p1", KEYS["colony"])
    assert db.kv_len(PACKS_TABLE, g["generatorid"]) == 2
    srv.stop()
    ref = RefSqliteDatabase(path)
    assert [p["arg"] for p in ref.kv_take_all("generator_packs", g["generatorid"])] == ["p0", "p1"]
