"""The port's databases (``repro_torch.broker.{MemoryDatabase,
SqliteDatabase}``) against the reference's (``repro.core``).

Each of the port's backends runs the same seeded operation sequences as
the reference's backend of its kind (the queue with targets, blocked
children, leases and wait deadlines; CFS revisions, listings, pins and
snapshots; cron, generator, kv and user tables; the dedup table) and gives
the same answers. Then the reference's database contract tests, copied
onto the port at their sizes: ``tests/test_broker_scale.py`` (10k memory,
2k sqlite), ``tests/test_cfs_scale.py``, the database cases of
``tests/test_cron_generator.py`` and ``tests/test_authz.py``,
``tests/test_property.py::test_db_backends_agree_on_queue_order``, and
every sqlite migration test among them, on the port's ``SqliteDatabase``.
The reference's tests run its server unsigned; the port's server
verifies every request, so these sign theirs."""

import json
import sqlite3

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.database as ref_database
from repro.core import MemoryDatabase as RefMemoryDatabase
from repro.core import SqliteDatabase as RefSqliteDatabase
from repro.core.errors import ConflictError as RefConflictError
from repro.core.process import Process as RefProcess
from repro.core.spec import FunctionSpec as RefFunctionSpec
from repro_torch.broker import ColoniesServer, MemoryDatabase, SqliteDatabase, standalone_server
from repro_torch.broker import database as port_database
from repro_torch.broker.database import Executor
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.errors import ConflictError
from repro_torch.core.process import FAILED, RUNNING, SUCCESSFUL, WAITING, Process, now_ns
from repro_torch.core.spec import FunctionSpec
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultPlan, FaultRule

BACKENDS = [MemoryDatabase, SqliteDatabase]
PAIRS = {"memory": (MemoryDatabase, RefMemoryDatabase), "sqlite": (SqliteDatabase, RefSqliteDatabase)}


def _spec(colony="scale", etype="worker", priority=0, names=None, **kw):
    d = {"conditions": {"colonyname": colony, "executortype": etype,
                        "executornames": names or []},
         "funcname": "echo", "priority": priority}
    d.update(kw)
    return FunctionSpec.from_dict(d)


def _proc(state=WAITING, ts=None, **kw):
    p = Process.create(_spec(**kw), submission_ns=ts)
    p.state = state
    return p


# ---------------------------------------------------------------------------
# The port's backends against the reference's, one seeded sequence each
# ---------------------------------------------------------------------------


class _Twin:
    """One operation sequence applied to a port database and a reference
    database of the same kind; ``trace`` holds both answers side by side."""

    def __init__(self, kind: str):
        port_cls, ref_cls = PAIRS[kind]
        self.dbs = (port_cls(), ref_cls())
        self.procs = (Process, RefProcess)
        self.trace: list[tuple] = []

    def add(self, p: Process) -> None:
        for db, cls in zip(self.dbs, self.procs):
            db.add_process(cls.from_dict(p.to_dict()))

    def mutate(self, pid: str, **fields) -> None:
        """Re-read, change and write back, as the server does under the lock."""
        for db in self.dbs:
            with db.colony_lock(db.get_process(pid).colonyname):
                p = db.get_process(pid)
                for k, v in fields.items():
                    setattr(p, k, v)
                db.update_process(p)
                if fields.get("state") == WAITING or fields.get("wait_for_parents") is False:
                    db.requeue(p)

    def ask(self, label: str, fn) -> None:
        self.trace.append((label, *(fn(db) for db in self.dbs)))


def _pids(procs) -> list[str]:
    return [p.processid for p in procs]


def _queue_sequence(kind: str, seed: int) -> _Twin:
    rng = np.random.default_rng(seed)
    tw = _Twin(kind)
    base = now_ns()
    colonies, etypes, names = ["c1", "c2"], ["w", "g"], ["x", "y", "z"]
    pids: list[str] = []
    for i in range(240):
        targets = [str(n) for n in rng.choice(names, int(rng.integers(0, 3)), replace=False)]
        spec = FunctionSpec.from_dict({
            "conditions": {"colonyname": str(rng.choice(colonies)),
                           "executortype": str(rng.choice(etypes)), "executornames": targets},
            "funcname": "f", "priority": int(rng.integers(0, 4))})
        # unique submission times: the sqlite queue orders by priority time only
        p = Process.create(spec, submission_ns=base - 10**12 + i * 1000)
        p.wait_for_parents = bool(rng.random() < 0.2)
        if rng.random() < 0.3:
            p.waitdeadline_ns = base + int(rng.integers(-10**9, 10**9))
        tw.add(p)
        pids.append(p.processid)

    def snapshot(step: int) -> None:
        for c in colonies:
            for e in etypes:
                for n in names + ["nobody"]:
                    tw.ask(f"{step} candidates {c} {e} {n}",
                           lambda db: _pids(db.candidates(c, e, n, limit=8)))
            tw.ask(f"{step} stats {c}", lambda db: db.colony_stats(c))
            for state in (None, WAITING, RUNNING, SUCCESSFUL):
                tw.ask(f"{step} list {c} {state}",
                       lambda db: sorted(_pids(db.list_processes(c, state, count=500))))
            tw.ask(f"{step} replica_state {c}", lambda db: sorted(db.replica_state(c)))
        tw.ask(f"{step} running past", lambda db: sorted(_pids(db.running_past_deadline(base))))
        tw.ask(f"{step} waiting past", lambda db: sorted(_pids(db.waiting_past_deadline(base))))

    snapshot(0)
    deleted: set[str] = set()
    for step in range(1, 4):
        for pid in rng.choice(pids, 40, replace=False):
            pid = str(pid)
            if pid in deleted:
                continue
            state = tw.dbs[0].get_process(pid).state
            r = rng.random()
            if state == WAITING and r < 0.5:
                tw.mutate(pid, state=RUNNING, assignedexecutorid="e",
                          deadline_ns=base + int(rng.integers(-10**9, 10**9)))
            elif state == WAITING and r < 0.7:
                tw.mutate(pid, wait_for_parents=False)
            elif state == RUNNING and r < 0.5:
                tw.mutate(pid, state=SUCCESSFUL if r < 0.3 else FAILED, deadline_ns=0)
            elif state == RUNNING:
                tw.mutate(pid, state=WAITING, assignedexecutorid="", deadline_ns=0,
                          retries=tw.dbs[0].get_process(pid).retries + 1)
            elif r < 0.1:
                for db in tw.dbs:
                    db.delete_process(pid)
                deleted.add(pid)
        snapshot(step)
    return tw


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_queue_answers_equal_the_reference(kind):
    tw = _queue_sequence(kind, seed=11)
    assert len(tw.trace) == 120
    for label, got, want in tw.trace:
        assert got == want, label
    # the sequence reached every kind of answer
    assert any(got for label, got, _ in tw.trace if "running past" in label)
    assert any(got for label, got, _ in tw.trace if "candidates" in label and label.endswith(" x"))


def _file(i: int, label: str, name: str, colony: str = "scale") -> dict:
    return {"fileid": f"f{i:08d}", "colonyname": colony, "label": label, "name": name,
            "size": 1, "checksum": f"{i:064x}",
            "storage": {"backend": "mem", "url": f"mem://{i:064x}"}, "added": i, "addedby": "t"}


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_cfs_answers_equal_the_reference(kind):
    rng = np.random.default_rng(12)
    tw = _Twin(kind)
    labels = ["/", "/a", "/a/b", "/ab", "/a/b/c", "/r/x"]
    fileids: list[str] = []
    for i in range(150):
        e = _file(i, str(rng.choice(labels)), f"n{int(rng.integers(0, 6))}",
                  colony=str(rng.choice(["scale", "other"])))
        tw.ask(f"add {i}", lambda db: db.cfs_add_file(e)["revision"])
        fileids.append(e["fileid"])
        if i % 25 == 24:
            snap = {"snapshotid": f"s{i}", "colonyname": "scale", "name": f"s{i}",
                    "label": str(rng.choice(labels)), "added": i}
            tw.ask(f"snapshot {i}", lambda db: db.cfs_create_snapshot(snap))
        if i % 10 == 9:
            fid = str(rng.choice(fileids))
            tw.ask(f"pins {fid}", lambda db: db.cfs_pin_count("scale", fid))

            def remove(db, fid=fid):
                try:
                    return db.cfs_remove_file("scale", fid)
                except (ConflictError, RefConflictError) as exc:
                    return f"conflict: {exc}"
            tw.ask(f"remove {fid}", remove)
    for c in ("scale", "other", "nobody"):
        for label in labels + ["/nope"]:
            tw.ask(f"list {c} {label}", lambda db: db.cfs_list(c, label))
            for n in range(6):
                tw.ask(f"head {c} {label} n{n}", lambda db: db.cfs_head(c, label, f"n{n}"))
        tw.ask(f"snapshots {c}", lambda db: db.cfs_list_snapshots(c))
    tw.ask("by ids", lambda db: db.cfs_get_files_by_ids("scale", fileids[::3] + ["ghost"]))
    tw.ask("get", lambda db: [db.cfs_get_file("scale", f) for f in fileids[:40]])
    tw.ask("remove snapshot", lambda db: db.cfs_remove_snapshot("scale", "s24"))
    tw.ask("get snapshot", lambda db: (db.cfs_get_snapshot("scale", "s49"),
                                       db.cfs_get_snapshot("scale", "s24")))
    for label, got, want in tw.trace:
        assert got == want, label
    assert any(isinstance(got, str) for _, got, _ in tw.trace)  # a pinned removal


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_tables_answer_as_the_reference(kind):
    """Cron due and listings, generators, kv buckets and lists, users,
    colonies, executors and functions."""
    rng = np.random.default_rng(13)
    tw = _Twin(kind)
    for i in range(40):
        entry = {"cronid": f"cron{i:02d}", "colonyname": f"c{i % 3}", "name": f"n{i}",
                 "deadline": int(rng.integers(0, 1000)), "added": int(rng.integers(0, 5))}
        tw.ask(f"cron put {i}", lambda db: db.cron_put(entry))
    for ts in (0, 250, 500, 1001):
        tw.ask(f"due {ts}", lambda db: sorted(e["cronid"] for e in db.cron_due(ts)))
    for i in range(0, 40, 7):
        tw.ask(f"cron del {i}", lambda db: db.cron_del(f"cron{i:02d}"))
        tw.ask(f"cron reschedule {i + 1}", lambda db: db.cron_put(
            dict(db.cron_get(f"cron{i + 1:02d}"), deadline=5000)))
    tw.ask("due after", lambda db: sorted(e["cronid"] for e in db.cron_due(1001)))
    for c in range(4):
        tw.ask(f"cron list {c}", lambda db: db.cron_list(f"c{c}"))
    for i in range(12):
        g = {"generatorid": f"g{i:02d}", "colonyname": f"c{i % 2}", "queuesize": 3,
             "added": int(rng.integers(0, 4))}
        tw.ask(f"gen put {i}", lambda db: db.generator_put(g))
    tw.ask("gen del", lambda db: db.generator_del("g03"))
    tw.ask("gen get", lambda db: (db.generator_get("g04"), db.generator_get("g03")))
    tw.ask("gen list", lambda db: (db.generator_list("c0"), db.generator_list("c1")))
    tw.ask("gen all", lambda db: sorted(e["generatorid"] for e in db.generator_all()))
    for i in range(30):
        t, k = f"t{i % 2}", f"k{int(rng.integers(0, 4))}"
        tw.ask(f"kv append {i}", lambda db: db.kv_append(t, k, {"i": i}))
        tw.ask(f"kv put {i}", lambda db: db.kv_put(t, k, {"v": i}))
    tw.ask("kv len", lambda db: [db.kv_len(f"t{j}", f"k{m}") for j in range(2) for m in range(4)])
    tw.ask("kv take", lambda db: db.kv_take_all("t0", "k1"))
    tw.ask("kv take again", lambda db: db.kv_take_all("t0", "k1"))
    tw.ask("kv get", lambda db: (db.kv_get("t1", "k2"), db.kv_get("t1", "nope")))
    tw.ask("kv del", lambda db: db.kv_del("t1", "k2"))
    tw.ask("kv list", lambda db: sorted(json.dumps(v) for v in db.kv_list("t1")))
    for i in range(10):
        u = {"userid": f"u{i}", "colonyname": f"c{i % 3}", "name": f"name{9 - i}"}
        tw.ask(f"user put {i}", lambda db: db.user_put(u))
    tw.ask("user move", lambda db: db.user_put({"userid": "u1", "colonyname": "c0", "name": "a"}))
    tw.ask("user del", lambda db: db.user_del("u2"))
    tw.ask("users", lambda db: [db.user_list(f"c{c}") for c in range(3)]
           + [db.user_get("u1"), db.user_get("u2")])
    tw.trace.append(("colonies", *(_colonies_and_executors(db, i)
                                   for i, db in enumerate(tw.dbs))))
    for label, got, want in tw.trace:
        assert got == want, label


def _colonies_and_executors(db, which: int) -> list:
    from repro.core.process import Colony as RefColony
    from repro.core.process import Executor as RefExecutor

    colony_cls = (port_database.Colony, RefColony)[which]
    executor_cls = (Executor, RefExecutor)[which]
    out = []
    db.add_colony(colony_cls(colonyname="dev", colonyid="id"))
    try:
        db.add_colony(colony_cls(colonyname="dev", colonyid="id"))
    except Exception as e:  # noqa: BLE001 - the two packages' ConflictError
        out.append(type(e).__name__)
    for i in range(3):
        db.add_executor(executor_cls(executorid=f"e{i}", executorname=f"n{i}", executortype="w",
                                     colonyname="dev", commissiontime_ns=i))
    try:
        db.add_executor(executor_cls(executorid="e9", executorname="n1", colonyname="dev"))
    except Exception as e:  # noqa: BLE001
        out.append(type(e).__name__)
    db.set_executor_state("e1", "approved")
    db.touch_executor("e1", 77)
    db.remove_executor("e2")
    db.add_function("e1", "dev", "train")
    out += [db.get_colony("dev").to_dict(), [c.to_dict() for c in db.list_colonies()],
            sorted((e.to_dict() for e in db.list_executors("dev")), key=lambda e: e["executorid"]),
            db.get_executor_by_name("dev", "n1").to_dict(), db.list_functions("dev"),
            db.list_functions("dev", "e0")]
    return out


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_dedup_answers_equal_the_reference(kind):
    """Replay, expiry, the per-colony cap at its size and replies kept
    apart from the caller's object. Which records the cap keeps is held to
    the reference's ``SqliteDatabase`` for both kinds: the reference's
    ``MemoryDatabase`` keeps every record (its FIFO drops each new key,
    ROADMAP C), which the port's does not copy."""
    tw = _Twin(kind)
    now = now_ns()
    reply = {"processid": "p", "out": [1, [2, {"x": None}]], "ok": True}
    tw.ask("put", lambda db: db.dedup_put("id:m0", "c1", now, reply))
    reply["out"].append("changed after the put")
    tw.ask("get", lambda db: db.dedup_get("id:m0"))
    tw.ask("old", lambda db: (db.dedup_put("id:old", "c1", now - port_database.DEDUP_TTL_NS - 1,
                                           {"a": 1}), db.dedup_get("id:old")))
    for label, got, want in tw.trace:
        assert got == want, label
    assert tw.trace[1][1] == {"processid": "p", "out": [1, [2, {"x": None}]], "ok": True}
    cap = port_database.DEDUP_MAX_PER_COLONY
    assert cap == ref_database.DEDUP_MAX_PER_COLONY == 4096
    kept = []
    for db in (tw.dbs[0], tw.dbs[1] if kind == "sqlite" else RefSqliteDatabase()):
        for i in range(cap + 256):  # a multiple of the sqlite eviction's 128 puts
            db.dedup_put(f"a:{i}", "busy", now + i, {"i": i})
        for i in range(64):
            db.dedup_put(f"q:{i}", "quiet", now + i, {"i": i})
        kept.append(([db.dedup_get(f"a:{i}") is not None for i in range(cap + 256)],
                     [db.dedup_get(f"q:{i}") for i in range(64)]))
    assert kept[0] == kept[1]
    if kind == "memory":  # exactly the cap; sqlite trims every 128 puts
        assert sum(kept[0][0]) == cap and not kept[0][0][255] and kept[0][0][256]
    assert all(kept[0][1]) and not kept[0][0][0]


# ---------------------------------------------------------------------------
# tests/test_broker_scale.py on the port
# ---------------------------------------------------------------------------


def _signed_server(db):
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    srv = standalone_server(Crypto.id(server_prv), db)
    client = Colonies(InProcTransport([srv]))
    client.add_colony("scale", Crypto.id(colony_prv), server_prv)
    return srv, client, colony_prv


@pytest.mark.parametrize("db_factory", BACKENDS)
def test_colonystats_counter_backed_at_10k(db_factory, monkeypatch):
    db = db_factory()
    srv, client, colony_prv = _signed_server(db)
    n = 10_000 if db_factory is MemoryDatabase else 2_000
    mix = (WAITING, RUNNING, SUCCESSFUL, FAILED, WAITING)
    for i in range(n):
        db.add_process(_proc(state=mix[i % len(mix)]))

    def no_scan(*a, **kw):
        raise AssertionError("colonystats scanned the process table")

    monkeypatch.setattr(db, "list_processes", no_scan)
    stats = client.stats("scale", colony_prv)
    assert stats["waiting"] == 2 * (n // 5)
    assert stats["running"] == stats["successful"] == stats["failed"] == n // 5
    srv.stop()


@pytest.mark.parametrize("db_factory", BACKENDS)
def test_colonystats_total_over_unknown_states(db_factory):
    db = db_factory()
    srv, client, colony_prv = _signed_server(db)
    db.add_process(_proc(state=WAITING))
    db.add_process(_proc(state="quarantined"))
    stats = client.stats("scale", colony_prv)
    assert stats["waiting"] == 1 and stats["quarantined"] == 1
    srv.stop()


def test_counters_track_full_lifecycle():
    db = MemoryDatabase()
    procs = [_proc() for _ in range(50)]
    for p in procs:
        db.add_process(p)
    assert db.colony_stats("scale") == {WAITING: 50}
    for p in procs[:30]:
        p.state = RUNNING
        db.update_process(p)
    for p in procs[:10]:
        p.state = SUCCESSFUL
        db.update_process(p)
    assert db.colony_stats("scale") == {WAITING: 20, RUNNING: 20, SUCCESSFUL: 10}
    db.delete_process(procs[0].processid)
    db.delete_process(procs[45].processid)
    assert db.colony_stats("scale") == {WAITING: 19, RUNNING: 20, SUCCESSFUL: 9}


def test_failsafe_bounded_work_at_10k():
    db = MemoryDatabase()
    srv = standalone_server(Crypto.id(Crypto.prvkey()), db)
    ts = now_ns()
    far = ts + 3600 * 10**9
    for i in range(10_000):
        p = _proc(state=RUNNING)
        p.deadline_ns = far + i
        db.add_process(p)
    expired_exec = []
    for _ in range(5):
        p = _proc(state=RUNNING, maxretries=2)
        p.deadline_ns = ts - 10**9
        db.add_process(p)
        expired_exec.append(p)
    for _ in range(3):
        p = _proc(state=WAITING)
        p.waitdeadline_ns = ts - 10**9
        db.add_process(p)
    db.metrics["deadline_pops"] = 0
    counters = srv.failsafe_scan()
    assert counters["reset"] == 5 and counters["waitexpired"] == 3
    assert db.metrics["deadline_pops"] <= 2 * (5 + 3)
    for p in expired_exec:
        assert p.state == WAITING and p.retries == 1
    db.metrics["deadline_pops"] = 0
    assert srv.failsafe_scan() == {"reset": 0, "failed": 0, "waitexpired": 0}
    assert db.metrics["deadline_pops"] <= 5 + 3
    srv.stop()


def test_failsafe_work_independent_of_fleet_size():
    pops = {}
    for fleet in (100, 10_000):
        db = MemoryDatabase()
        srv = standalone_server(Crypto.id(Crypto.prvkey()), db)
        ts = now_ns()
        for i in range(fleet):
            p = _proc(state=RUNNING)
            p.deadline_ns = ts + 3600 * 10**9 + i
            db.add_process(p)
        for _ in range(4):
            p = _proc(state=RUNNING)
            p.deadline_ns = ts - 10**9
            db.add_process(p)
        db.metrics["deadline_pops"] = 0
        srv.failsafe_scan()
        pops[fleet] = db.metrics["deadline_pops"]
        srv.stop()
    assert pops[100] == pops[10_000]


@pytest.mark.parametrize("db_factory", BACKENDS)
def test_candidates_never_blocked_or_wrongly_targeted(db_factory):
    db = db_factory()
    base = now_ns()
    pinned_me, open_procs = [], []
    for i in range(200):
        p = _proc(ts=base - 10**9 + i)
        p.wait_for_parents = True
        db.add_process(p)
    for i in range(200):
        db.add_process(_proc(ts=base - 5 * 10**8 + i, names=["someone-else"]))
    for i in range(3):
        p = _proc(ts=base + i, names=["me"])
        db.add_process(p)
        pinned_me.append(p.processid)
    for i in range(3):
        p = _proc(ts=base + 100 + i)
        db.add_process(p)
        open_procs.append(p.processid)
    got = db.candidates("scale", "worker", "me", limit=8)
    assert _pids(got) == pinned_me + open_procs
    for p in got:
        assert p.queue_ready
        assert not p.spec.conditions.executornames or "me" in p.spec.conditions.executornames
    assert _pids(db.candidates("scale", "worker", "other-worker", limit=8)) == open_procs


def test_stale_entries_are_evicted():
    db = MemoryDatabase()
    procs = [_proc(ts=now_ns() + i) for i in range(1000)]
    for p in procs:
        db.add_process(p)
    shard = db._shard("scale")
    assert len(shard.queues["worker"]) == 1000
    for p in procs[:600]:
        p.state = SUCCESSFUL
        db.update_process(p)
    assert len(shard.queues["worker"]) == 499
    assert db.metrics["compactions"] >= 1
    before = db.metrics["stale_evicted"]
    assert len(db.candidates("scale", "worker", "w", limit=8)) == 8
    assert db.metrics["stale_evicted"] == before + 99
    assert len(shard.queues["worker"]) == 400
    for p in procs[600:620]:
        p.state = FAILED
        db.update_process(p)
    assert len(db.candidates("scale", "worker", "w", limit=8)) == 8
    assert len(shard.queues["worker"]) == 380


def test_requeue_is_duplicate_free():
    db = MemoryDatabase()
    p = _proc()
    db.add_process(p)
    db.requeue(p)
    db.requeue(p)
    assert len(db._shard("scale").queues["worker"]) == 1


@pytest.mark.parametrize("db_factory", BACKENDS)
def test_released_child_reenters_queue(db_factory):
    db = db_factory()
    child = _proc()
    child.wait_for_parents = True
    db.add_process(child)
    assert db.candidates("scale", "worker", "w") == []
    child.wait_for_parents = False
    db.update_process(child)
    db.requeue(child)
    assert _pids(db.candidates("scale", "worker", "w")) == [child.processid]


def test_multi_target_stale_entries_compact():
    db = MemoryDatabase()
    procs = [_proc(names=["a", "b"]) for _ in range(200)]
    for p in procs:
        db.add_process(p)
    shard = db._shard("scale")
    assert len(shard.targeted["worker"]["a"]) == len(shard.targeted["worker"]["b"]) == 200
    for p in procs:
        p.state = SUCCESSFUL
        db.update_process(p)
    assert db.metrics["compactions"] >= 1
    assert len(shard.targeted.get("worker", {}).get("b", [])) < 200


def test_sqlite_migration_backfills_targets(tmp_path):
    path = str(tmp_path / "old.db")
    pinned, open_p = _proc(names=["gpu-1"]), _proc()
    conn = sqlite3.connect(path)
    conn.executescript("""
        CREATE TABLE processes (
            processid TEXT PRIMARY KEY, colonyname TEXT NOT NULL,
            executortype TEXT NOT NULL, state TEXT NOT NULL,
            waitforparents INTEGER NOT NULL DEFAULT 0,
            prioritytime INTEGER NOT NULL, deadline INTEGER NOT NULL DEFAULT 0,
            waitdeadline INTEGER NOT NULL DEFAULT 0, body TEXT NOT NULL
        );
    """)
    for p in (pinned, open_p):
        conn.execute("INSERT INTO processes VALUES (?,?,?,?,?,?,?,?,?)",
                     (p.processid, p.colonyname, "worker", p.state, 0, p.priority_time, 0, 0,
                      p.to_json()))
    conn.commit()
    conn.close()
    db = SqliteDatabase(path)
    assert _pids(db.candidates("scale", "worker", "cpu-9")) == [open_p.processid]
    assert set(_pids(db.candidates("scale", "worker", "gpu-1"))) == {pinned.processid,
                                                                      open_p.processid}
    assert db.colony_stats("scale") == {WAITING: 2}  # counts rebuilt on open


def test_ha_assign_confirms_apply_won():
    """The Raft apply lost its CAS (the cluster swallows that conflict):
    assign hands the executor nothing."""
    db = MemoryDatabase()
    srv = ColoniesServer("srv", db)
    srv.set_op_proposer(lambda op: None)  # the proposal commits, the apply loses
    db.add_process(_proc())
    ex = Executor(executorid="e1", executorname="w", executortype="worker",
                  colonyname="scale", state="approved")
    assert srv._try_assign_once("scale", ex) is None


def test_backends_agree_on_candidate_order():
    dbs = [MemoryDatabase(), SqliteDatabase()]
    base = now_ns()
    for i in range(60):
        spec = _spec(priority=i % 3)
        for db in dbs:
            db.add_process(Process.create(spec, submission_ns=base + i * 1000))
    orders = [[p.priority_time for p in db.candidates("scale", "worker", "w", limit=30)]
              for db in dbs]
    assert orders[0] == orders[1] == sorted(orders[0])


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 10**15), st.integers(0, 3)), min_size=1, max_size=12))
def test_db_backends_agree_on_queue_order(subs):
    """tests/test_property.py's: both backends pop in the same order, and
    the order is ascending priority time."""
    procs = []
    for i, (ts, pr) in enumerate(subs):
        spec = FunctionSpec.from_dict({"conditions": {"colonyname": "c", "executortype": "w"},
                                       "funcname": "f", "priority": pr})
        procs.append(Process.create(spec, submission_ns=ts * 1000 + i))  # unique ts
    orders = []
    for db in (MemoryDatabase(), SqliteDatabase()):
        for p in procs:
            db.add_process(Process.from_dict(p.to_dict()))
        orders.append(_pids(db.candidates("c", "w", "any", limit=50)))
    assert orders[0] == orders[1]
    pts = {p.processid: p.priority_time for p in procs}
    assert [pts[x] for x in orders[0]] == sorted(pts[x] for x in orders[0])


@pytest.mark.parametrize("db_factory", BACKENDS)
def test_db_commit_fault_site(db_factory):
    """``db.commit`` fires at the entry of ``add_process`` and
    ``update_process``, before any lock: the write does not happen, and
    the next one goes through."""
    db = db_factory()
    p = _proc()
    plan = FaultPlan([FaultRule("db.commit", "crash", match={"method": "add_process"}),
                      FaultRule("db.commit", "crash", match={"method": "update_process"})])
    with faults.active(plan):
        with pytest.raises(faults.FaultInjected):
            db.add_process(p)
        assert db.colony_stats("scale") == {}
        db.add_process(p)
        q = db.get_process(p.processid)
        q.state = RUNNING
        with pytest.raises(faults.FaultInjected):
            db.update_process(q)
        q = db.get_process(p.processid)
        q.state = SUCCESSFUL
        db.update_process(q)
    assert plan.fired() == 2
    assert db.colony_stats("scale") == {SUCCESSFUL: 1}


def test_ref_spec_and_port_spec_make_equal_bodies():
    """The sqlite ``body`` column holds ``Process.to_json()``: the port's
    must be the reference's byte for byte for a file to cross packages."""
    d = {"conditions": {"colonyname": "c", "executortype": "w", "executornames": ["a"]},
         "funcname": "f", "priority": 2, "args": [1, "x"], "kwargs": {"k": [None]},
         "maxexectime": 30, "maxretries": 3}
    p = Process.create(FunctionSpec.from_dict(d), submission_ns=123)
    r = RefProcess.create(RefFunctionSpec.from_dict(d), submission_ns=123)
    r.processid = p.processid
    assert p.to_json() == r.to_json()
    assert port_database._SCHEMA == ref_database._SCHEMA


# ---------------------------------------------------------------------------
# tests/test_cfs_scale.py on the port
# ---------------------------------------------------------------------------


def test_cfs_ops_bounded_at_10k_files():
    db = MemoryDatabase()
    for i in range(10_000):
        db.cfs_add_file(_file(i, f"/bulk/s{i % 64:02d}", f"c{i:06d}"))
    for i in range(20):
        db.cfs_add_file(_file(100_000 + i, "/hot", f"h{i:04d}"))
    db.metrics["cfs_nodes_visited"] = 0
    assert len(db.cfs_list("scale", "/hot")) == 20
    assert db.metrics["cfs_nodes_visited"] <= 2
    db.metrics["cfs_nodes_visited"] = 0
    head = db.cfs_head("scale", "/hot", "h0010")
    assert head is not None and head["revision"] == 1
    assert db.metrics["cfs_nodes_visited"] == 0
    snap = db.cfs_create_snapshot({"snapshotid": "s1", "colonyname": "scale", "name": "s",
                                   "label": "/hot"})
    assert len(snap["fileids"]) == 20
    assert db.cfs_pin_count("scale", snap["fileids"][0]) == 1
    with pytest.raises(ConflictError):
        db.cfs_remove_file("scale", snap["fileids"][0])


def test_cfs_root_listing_visits_only_live_labels():
    db = MemoryDatabase()
    for i in range(200):
        db.cfs_add_file(_file(i, f"/r/l{i % 4}", "f"))
    db.metrics["cfs_nodes_visited"] = 0
    files = db.cfs_list("scale", "/")
    assert len(files) == 4 and all(f["revision"] == 50 for f in files)
    assert db.metrics["cfs_nodes_visited"] <= 6


def _norm(e: dict) -> tuple:
    return (e["label"], e["name"], e["revision"], e["checksum"], e["size"])


def _drive_cfs(db) -> list:
    """tests/test_cfs_scale.py's scripted CFS session, signed."""
    srv, client, prv = _signed_server(db)
    trace: list = []
    try:
        def add(label, name, i):
            return client.add_file({"colonyname": "scale", "label": label, "name": name,
                                    "size": 1, "checksum": f"{i:064x}",
                                    "storage": {"backend": "mem", "url": f"mem://{i:064x}"}}, prv)

        add("/", "root.txt", 1)
        add("/a", "x.txt", 2)
        add("/a", "x.txt", 3)
        add("/a/b", "deep.txt", 4)
        add("/ab", "sibling.txt", 5)
        scratch = add("/scratch", "tmp.txt", 6)
        trace.append([_norm(e) for e in client.get_files("scale", "/", prv)])
        trace.append([_norm(e) for e in client.get_files("scale", "/a", prv)])
        trace.append([_norm(e) for e in client.get_files("scale", "/nope", prv)])
        trace.append(_norm(client.get_file("scale", "/a", "x.txt", prv)))
        snap = client.create_snapshot("scale", "/a", "s1", prv)
        trace.append(len(snap["fileids"]))
        trace.append([_norm(e) for e in client.get_snapshot("scale", snap["snapshotid"],
                                                             prv)["files"]])
        pinned = client.get_file("scale", "/a", "x.txt", prv)
        try:
            client.remove_file("scale", pinned["fileid"], prv)
            trace.append("removed-pinned")
        except ConflictError:
            trace.append("pin-conflict")
        client.remove_file("scale", scratch["fileid"], prv)
        trace.append([_norm(e) for e in client.get_files("scale", "/scratch", prv)])
        client.remove_snapshot("scale", snap["snapshotid"], prv)
        client.remove_file("scale", pinned["fileid"], prv)
        trace.append(_norm(client.get_file("scale", "/a", "x.txt", prv)))
        trace.append([_norm(e) for e in client.get_files("scale", "/", prv)])
    finally:
        srv.stop()
    return trace


def test_backends_agree_on_cfs_results():
    mem_trace, sql_trace = _drive_cfs(MemoryDatabase()), _drive_cfs(SqliteDatabase())
    assert mem_trace == sql_trace
    assert mem_trace[2] == []
    assert mem_trace[3][2] == 2
    assert mem_trace[6] == "pin-conflict"
    assert mem_trace[8][2] == 1


@pytest.mark.parametrize("db_factory", BACKENDS)
def test_revision_heads_monotonic(db_factory):
    db = db_factory()
    assert [db.cfs_add_file(_file(i, "/m", "f"))["revision"] for i in range(5)] == [1, 2, 3, 4, 5]
    db.cfs_remove_file("scale", db.cfs_head("scale", "/m", "f")["fileid"])
    assert db.cfs_head("scale", "/m", "f")["revision"] == 4
    assert db.cfs_add_file(_file(99, "/m", "f"))["revision"] == 5


@pytest.mark.parametrize("db_factory", BACKENDS)
def test_batched_file_lookup_preserves_order_and_gaps(db_factory):
    db = db_factory()
    ids = [db.cfs_add_file(_file(i, "/b", f"f{i:04d}"))["fileid"] for i in range(600)]
    got = db.cfs_get_files_by_ids("scale", [ids[599], "ghost", ids[0], ids[300]])
    assert [e["fileid"] if e else None for e in got] == [ids[599], None, ids[0], ids[300]]


@pytest.mark.parametrize("db_factory", BACKENDS)
def test_pin_refcount_lifecycle(db_factory):
    db = db_factory()
    e = db.cfs_add_file(_file(0, "/p", "f"))
    s1 = db.cfs_create_snapshot({"snapshotid": "s1", "colonyname": "scale", "name": "a",
                                 "label": "/p"})
    s2 = db.cfs_create_snapshot({"snapshotid": "s2", "colonyname": "scale", "name": "b",
                                 "label": "/p"})
    assert s1["fileids"] == s2["fileids"] == [e["fileid"]]
    assert db.cfs_pin_count("scale", e["fileid"]) == 2
    with pytest.raises(ConflictError):
        db.cfs_remove_file("scale", e["fileid"])
    db.cfs_remove_snapshot("scale", "s1")
    assert db.cfs_pin_count("scale", e["fileid"]) == 1
    with pytest.raises(ConflictError):
        db.cfs_remove_file("scale", e["fileid"])
    db.cfs_remove_snapshot("scale", "s2")
    assert db.cfs_pin_count("scale", e["fileid"]) == 0
    assert db.cfs_remove_file("scale", e["fileid"]) is not None
    assert db.cfs_head("scale", "/p", "f") is None


def test_sqlite_migration_backfills_cfs_from_kv(tmp_path):
    path = str(tmp_path / "cfs.db")
    old = SqliteDatabase(path)
    e = dict(_file(1, "/mig", "f.txt"), revision=1)
    old.kv_put("cfs_files", e["fileid"], e)
    old.kv_put("cfs_snapshots", "snap1",
               {"snapshotid": "snap1", "colonyname": "scale", "name": "s", "label": "/mig",
                "fileids": [e["fileid"], "ghost-fileid"], "added": 0})
    db = SqliteDatabase(path)
    assert db.cfs_head("scale", "/mig", "f.txt")["fileid"] == e["fileid"]
    assert [f["name"] for f in db.cfs_list("scale", "/")] == ["f.txt"]
    assert db.cfs_pin_count("scale", e["fileid"]) == 1
    with pytest.raises(ConflictError):
        db.cfs_remove_file("scale", e["fileid"])
    assert db.cfs_get_snapshot("scale", "snap1")["fileids"] == [e["fileid"], "ghost-fileid"]
    assert db.kv_list("cfs_files") == [] and db.kv_list("cfs_snapshots") == []


def test_sqlite_migration_resequences_colliding_revisions(tmp_path):
    path = str(tmp_path / "collide.db")
    old = SqliteDatabase(path)
    for fid in ("aaaa", "bbbb"):
        old.kv_put("cfs_files", fid, dict(_file(1, "/dup", "f.txt"), fileid=fid, revision=1,
                                          checksum=fid * 16))
    db = SqliteDatabase(path)
    assert len(db.cfs_list("scale", "/dup")) == 1
    with db._lock:
        rows = db._exec("SELECT revision FROM cfs_files WHERE colonyname='scale'"
                        " AND label='/dup'").fetchall()
    assert sorted(r for (r,) in rows) == [1, 2]
    assert db.cfs_get_file("scale", "aaaa") is not None
    assert db.cfs_get_file("scale", "bbbb") is not None
    assert db.cfs_head("scale", "/dup", "f.txt")["revision"] == 2


# ---------------------------------------------------------------------------
# the database cases of tests/test_cron_generator.py and tests/test_authz.py
# ---------------------------------------------------------------------------

WF = {"colonyname": "dev", "functionspecs": [
    {"nodename": "tick", "funcname": "tick",
     "conditions": {"executortype": "worker", "dependencies": []}}]}


def _cron_entry(cronid, colony, deadline, **kw):
    e = {"cronid": cronid, "colonyname": colony, "name": cronid, "interval": 1.0,
         "cronexpr": "", "workflow": WF, "deadline": deadline, "lastrun": 0, "runs": 0,
         "lastworkflowid": "", "added": deadline}
    e.update(kw)
    return e


@pytest.mark.parametrize("db_factory", [None, "sqlite"])
def test_cron_due_uses_deadline_index(db_factory, tmp_path):
    db = MemoryDatabase() if db_factory is None else SqliteDatabase(str(tmp_path / "c.db"))
    db.cron_put(_cron_entry("early", "c1", 100))
    db.cron_put(_cron_entry("late", "c1", 10_000))
    db.cron_put(_cron_entry("other", "c2", 150))
    assert sorted(e["cronid"] for e in db.cron_due(200)) == ["early", "other"]
    db.cron_del("early")
    assert [e["cronid"] for e in db.cron_due(200)] == ["other"]
    db.cron_put(_cron_entry("other", "c2", 50_000))
    assert db.cron_due(200) == []
    assert [e["cronid"] for e in db.cron_due(60_000)] == ["late", "other"]


@pytest.mark.parametrize("db_factory", [None, "sqlite"])
def test_cron_generator_listings_are_per_colony(db_factory, tmp_path):
    db = MemoryDatabase() if db_factory is None else SqliteDatabase(str(tmp_path / "l.db"))
    db.cron_put(_cron_entry("a", "c1", 1))
    db.cron_put(_cron_entry("b", "c2", 2))
    assert [e["cronid"] for e in db.cron_list("c1")] == ["a"]
    db.generator_put({"generatorid": "g1", "colonyname": "c1", "queuesize": 2, "added": 1})
    db.generator_put({"generatorid": "g2", "colonyname": "c2", "queuesize": 2, "added": 2})
    assert [g["generatorid"] for g in db.generator_list("c2")] == ["g2"]
    assert {g["generatorid"] for g in db.generator_all()} == {"g1", "g2"}
    db.generator_del("g1")
    assert db.generator_get("g1") is None
    assert [g["generatorid"] for g in db.generator_all()] == ["g2"]


def test_sqlite_migration_lifts_cron_generator_kv_rows(tmp_path):
    path = str(tmp_path / "old.db")
    old = SqliteDatabase(path)
    old.kv_put("crons", "legacy-cron", _cron_entry("legacy-cron", "dev", 123, runs=7))
    old.kv_put("generators", "legacy-gen",
               {"generatorid": "legacy-gen", "colonyname": "dev", "name": "g", "workflow": WF,
                "queuesize": 3, "timeout": 0, "firstpack": 0, "runs": 2})
    db = SqliteDatabase(path)
    assert db.cron_get("legacy-cron")["runs"] == 7
    assert [e["cronid"] for e in db.cron_list("dev")] == ["legacy-cron"]
    assert [e["cronid"] for e in db.cron_due(200)] == ["legacy-cron"]
    assert db.generator_get("legacy-gen")["queuesize"] == 3
    assert db.kv_list("crons") == [] and db.kv_list("generators") == []


@pytest.mark.parametrize("make_db", BACKENDS)
def test_user_table_roundtrip(make_db):
    db = make_db()
    db.user_put({"userid": "u1", "colonyname": "dev", "name": "bob"})
    db.user_put({"userid": "u2", "colonyname": "dev", "name": "alice"})
    db.user_put({"userid": "u3", "colonyname": "ops", "name": "eve"})
    assert db.user_get("u1")["name"] == "bob"
    assert db.user_get("missing") is None
    assert [u["userid"] for u in db.user_list("dev")] == ["u2", "u1"]
    db.user_put({"userid": "u1", "colonyname": "ops", "name": "bob"})
    assert [u["userid"] for u in db.user_list("dev")] == ["u2"]
    assert sorted(u["userid"] for u in db.user_list("ops")) == ["u1", "u3"]
    db.user_del("u2")
    assert db.user_get("u2") is None
    assert db.user_list("dev") == []


def test_sqlite_migration_lifts_user_kv_rows(tmp_path):
    path = str(tmp_path / "old.db")
    SqliteDatabase(path).kv_put("users", "u-legacy", {"userid": "u-legacy", "colonyname": "dev",
                                                      "username": "legacy"})
    db = SqliteDatabase(path)
    assert db.user_get("u-legacy")["username"] == "legacy"
    assert [u["userid"] for u in db.user_list("dev")] == ["u-legacy"]
    assert db.kv_list("users") == []


def test_sqlite_migration_rebuilds_missing_counts(tmp_path):
    """A file whose ``proc_counts`` is empty but holds processes gets its
    counters rebuilt on open, so colonystats stays a counter read."""
    path = str(tmp_path / "counts.db")
    db = SqliteDatabase(path)
    for state in (WAITING, WAITING, SUCCESSFUL):
        db.add_process(_proc(state=state))
    with db._lock:
        db._exec("DELETE FROM proc_counts")
        db._conn.commit()
    assert SqliteDatabase(path).colony_stats("scale") == {WAITING: 2, SUCCESSFUL: 1}
