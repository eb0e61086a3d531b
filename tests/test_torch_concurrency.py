"""``tests/test_concurrency.py`` on the port's analysis plane
(``repro_torch.analysis``) and the port's broker: the lock-order detector
catches seeded violations, ``@requires_lock`` / ``@no_locks_held`` raise on
seeded breaches and pass on the real call paths, the lint flags each
seeded rule and passes the port's tree, and the port's multi-threaded
broker (both databases) and its replicated broker through a failover run
clean under the detectors. Each of the port's lint results is also held
to the reference's lint on the same source, rule and line."""

import os
import threading
import time

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import authtrack, lint, locktrack, statehash
from repro_torch.analysis.contracts import LockContractError, no_locks_held, requires_lock
from repro_torch.broker import HAColonyCluster, MemoryDatabase, SqliteDatabase, standalone_server
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.executor import ExecutorBase
from repro_torch.core.retry import RetryPolicy

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture()
def tracking():
    """Detector on, clean slate; restore the prior mode and wipe seeded noise."""
    prev = locktrack.is_enabled()
    locktrack.enable(True)
    locktrack.reset()
    yield
    locktrack.reset()
    locktrack.enable(prev)


@pytest.fixture()
def all_checks(tracking):
    """The lock-order detector, the auth-fact contracts and the replication
    digests on together, as in a broker process of ``chip_smoke.py``."""
    prev_auth, prev_repl = authtrack.is_enabled(), statehash.is_enabled()
    authtrack.enable(True)
    statehash.enable(True)
    yield
    authtrack.enable(prev_auth)
    statehash.enable(prev_repl)


def _kinds():
    return [v["kind"] for v in locktrack.violations()]


# ---------------------------------------------------------------------------
# Seeded-violation proofs: the detector fires
# ---------------------------------------------------------------------------


def test_detector_catches_lock_order_cycle(tracking):
    a = locktrack.TrackedRLock("alpha")
    b = locktrack.TrackedRLock("beta")
    with a:
        with b:  # edge alpha -> beta
            pass
    assert _kinds() == []
    with b:
        with a:  # edge beta -> alpha closes the cycle
            pass
    assert "lock-order-cycle" in _kinds()


def test_detector_catches_cross_shard_nesting(tracking):
    s1 = locktrack.TrackedRLock("shard:c1")
    s2 = locktrack.TrackedRLock("shard:c2")
    with s1:
        with s2:
            pass
    assert "cross-instance" in _kinds()


def test_detector_catches_acquire_under_leaf(tracking):
    g = locktrack.TrackedRLock("glock")
    other = locktrack.TrackedRLock("shard:x")
    with g:
        with other:
            pass
    assert "acquire-under-leaf" in _kinds()


def test_detector_catches_wait_under_lock(tracking):
    held = locktrack.TrackedRLock("shard:w")
    cv = threading.Condition(locktrack.make_lock("queuecv:w:worker"))
    with held:
        with cv:
            cv.wait(timeout=0.01)
    assert "wait-under-lock" in _kinds()


def test_declared_wait_allowance_suppresses_only_that_pairing(tracking):
    """allow_wait("raft", "assignlocal") (broker/raft.py) lets
    propose_and_wait park on commit_cv under the leader-local assign lock;
    any other held family still fires."""
    import repro_torch.broker.raft  # noqa: F401  — registers the allowance

    allowed = locktrack.TrackedRLock("assignlocal:dev")
    cv = threading.Condition(locktrack.make_lock("raft:n0"))
    with allowed:
        with cv:
            cv.wait(timeout=0.01)
    assert "wait-under-lock" not in _kinds()
    other = locktrack.TrackedRLock("shard:dev")
    with other:
        with cv:
            cv.wait(timeout=0.01)
    assert "wait-under-lock" in _kinds()


def test_reentrant_acquire_is_not_a_violation(tracking):
    s = locktrack.TrackedRLock("shard:re")
    with s:
        with s:  # re-entrant on the same instance: fine
            pass
    assert _kinds() == []


def test_condition_wait_keeps_held_set_accurate(tracking):
    """After a Condition.wait() round trip the lock is held again exactly
    as before (the _release_save/_acquire_restore protocol)."""
    lk = locktrack.TrackedRLock("queuecv:acc:worker")
    cv = threading.Condition(lk)
    with cv:
        assert lk.held_by_current_thread()
        cv.wait(timeout=0.01)
        assert lk.held_by_current_thread()
    assert not lk.held_by_current_thread()
    assert _kinds() == []


def test_broker_locks_come_from_make_lock(tracking):
    """Every lock of the port's broker, built while the detector is on, is
    a tracked lock of the reference's family (a plain lock would escape the
    detector, and a Lock that must not re-enter would deadlock as an
    RLock)."""
    srv = standalone_server(Crypto.id(Crypto.prvkey()), MemoryDatabase())
    db = srv.db
    families = {db._shard("dev").lock.family, db._cfs("dev").lock.family, db._glock.family,
                srv._signal(("dev", "worker")).cv._lock.family, srv._signals_guard.family,
                srv._local_assign_lock("dev").family}
    assert families == {"shard", "cfs", "glock", "queuecv", "signals", "assignlocal"}
    sq = SqliteDatabase()
    assert {sq._lock.family, sq.colony_lock("dev").family} == {"sqlite", "dbcolony"}
    cluster = HAColonyCluster(Crypto.id(Crypto.prvkey()), replicas=3, seed=1)
    node = next(iter(cluster.raft.nodes.values()))
    assert {node.lock.family, cluster.raft._lock.family, cluster._applied_lock.family} == {
        "raft", "cluster", "applied"}
    assert node.commit_cv._lock is node.lock


# ---------------------------------------------------------------------------
# Contract decorators
# ---------------------------------------------------------------------------


class _FakeShard:
    def __init__(self, name="shard:z"):
        self.lock = locktrack.TrackedRLock(name)


def test_requires_lock_raises_without_lock(tracking):
    @requires_lock("shard")
    def touch(s):
        return "ok"

    s = _FakeShard()
    with pytest.raises(LockContractError):
        touch(s)
    with s.lock:
        assert touch(s) == "ok"


@pytest.mark.parametrize("family", ["cfs", "shard", "sqlite"])
def test_requires_lock_fires_on_real_database_method(tracking, family):
    """The port database's decorated internals enforce their contract."""
    if family == "cfs":
        db = MemoryDatabase()
        shard = db._cfs("dev")
        call, lock = (lambda: db._cfs_list_locked(shard, "/a")), shard.lock
    elif family == "shard":
        db = MemoryDatabase()
        shard = db._shard("dev")
        call, lock = (lambda: db._maybe_compact(shard, "worker")), shard.lock
    else:
        db = SqliteDatabase()
        call, lock = (lambda: db._cfs_list_locked("dev", "/a")), db._lock
    with pytest.raises(LockContractError):
        call()
    with lock:
        assert call() in ([], None)


def test_no_locks_held_raises_when_holding(tracking):
    @no_locks_held()
    def block():
        return "ok"

    @no_locks_held("shard")
    def block_db_only():
        return "ok"

    s = _FakeShard()
    assert block() == "ok"
    with s.lock:
        with pytest.raises(LockContractError):
            block()
        with pytest.raises(LockContractError):
            block_db_only()
    other = locktrack.TrackedRLock("assignlocal:c9")
    with other:
        # family filter: assignlocal is legitimately held across Raft waits
        assert block_db_only() == "ok"


def test_blocking_broker_entry_points_refuse_a_held_lock(tracking):
    """``assign`` and ``failsafe_scan`` (no lock at all) and
    ``propose_and_wait`` (no database lock) raise when entered holding one."""
    srv = standalone_server(Crypto.id(Crypto.prvkey()), MemoryDatabase())
    cluster = HAColonyCluster(Crypto.id(Crypto.prvkey()), replicas=3, seed=2)
    with srv.db.colony_lock("dev"):
        with pytest.raises(LockContractError):
            srv.failsafe_scan()
        with pytest.raises(LockContractError):
            srv.assign("dev", None, 0.0)
        with pytest.raises(LockContractError):
            cluster.raft.propose_and_wait("n0", {"op": "noop"})
    assert srv.failsafe_scan() == {"reset": 0, "failed": 0, "waitexpired": 0}


def test_decorators_pass_through_when_disabled():
    prev = locktrack.is_enabled()
    locktrack.enable(False)
    try:

        @requires_lock("shard")
        def touch(s):
            return "ok"

        assert touch(_FakeShard()) == "ok"  # no lock held, no check
    finally:
        locktrack.enable(prev)


# ---------------------------------------------------------------------------
# Static lint: seeded sources trip each rule, the port's tree is clean
# ---------------------------------------------------------------------------

SEEDED = {
    "kv-list": "def tick(self):\n    return self.db.kv_list('crons')\n",
    "kv-list-migrate": "def _migrate_x(self):\n    return self.db.kv_list('crons')\n",
    "sleep-under-glock": "import time\ndef f(self):\n    with self._glock:\n        time.sleep(1)\n",
    "lock-under-glock": "def f(self, s):\n    with self._glock:\n        with s.lock:\n            pass\n",
    "bare-except": "try:\n    pass\nexcept:\n    pass\n",
    "mutable-default": "def f(x=[]):\n    pass\n",
    "shard-no-contract": "def _mutate(self, s: _ColonyShard) -> None:\n    s.procs.clear()\n",
    "shard-contract": ("@requires_lock('shard')\n"
                       "def _mutate(self, s: _ColonyShard) -> None:\n    s.procs.clear()\n"),
    "syntax-error": "def f(:\n",
}
WANT = {"kv-list": ["LNT001"], "kv-list-migrate": [], "sleep-under-glock": ["LNT002"],
        "lock-under-glock": ["LNT002"], "bare-except": ["LNT003"],
        "mutable-default": ["LNT004"], "shard-no-contract": ["LNT005"], "shard-contract": [],
        "syntax-error": ["LNT000"]}


def _pairs(vs):
    return [(v.rule, v.line) for v in vs]


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_lint_flags_each_seeded_rule_as_the_reference_does(name):
    got = lint.lint_source(SEEDED[name], "seeded.py")
    assert sorted({v.rule for v in got}) == WANT[name]
    assert _pairs(got) == _pairs(ref_lint.lint_source(SEEDED[name], "seeded.py"))


@pytest.mark.parametrize("tree", ["src/repro", "src/repro_torch"])
def test_lint_matches_the_reference_on_both_trees(tree):
    path = os.path.join(ROOT, tree)
    n, got = lint.run([path])
    n_ref, want = ref_lint.run([path])
    assert n == n_ref > 20
    assert [(v.path, v.rule, v.line) for v in got] == [(v.path, v.rule, v.line) for v in want]


def test_lint_port_tree_is_clean(monkeypatch):
    """``python -m repro_torch.analysis.lint`` with no arguments, from the
    repo's root: the port's tree, zero violations."""
    monkeypatch.chdir(ROOT)
    assert lint.DEFAULT_PATHS == ("src/repro_torch",)
    nfiles, vs = lint.run()
    assert nfiles > 80
    assert [str(v) for v in vs] == []
    assert lint.main([]) == 0


# ---------------------------------------------------------------------------
# Hold times: per-family stats, long-hold warnings, wait exemption
# ---------------------------------------------------------------------------


@pytest.fixture()
def hold_warn(tracking):
    """Yields set_hold_warn_ms; restores the configured threshold after."""
    prev = locktrack._REG.hold_warn_ns
    yield locktrack.set_hold_warn_ms
    locktrack._REG.hold_warn_ns = prev


def test_hold_times_recorded_per_family(tracking):
    s = locktrack.TrackedRLock("shard:hold")
    with s:
        time.sleep(0.02)
    with s:
        pass
    fam = locktrack.hold_stats()["shard"]
    assert fam["count"] == 2
    assert fam["max_ns"] >= 15_000_000
    assert 0 < fam["mean_ns"] <= fam["max_ns"]
    assert fam["max_lock"] == "shard:hold"


def test_reentrant_hold_timed_from_outermost_acquire(tracking):
    s = locktrack.TrackedRLock("shard:re-hold")
    with s:
        with s:  # inner re-acquire must not split or restart the hold
            time.sleep(0.01)
    fam = locktrack.hold_stats()["shard"]
    assert fam["count"] == 1
    assert fam["max_ns"] >= 8_000_000


def test_long_hold_warns_but_is_not_a_violation(hold_warn):
    hold_warn(5)
    g = locktrack.TrackedRLock("glock")
    with g:
        time.sleep(0.02)
    ws = locktrack.hold_warnings()
    assert len(ws) == 1 and ws[0]["lock"] == "glock"
    assert ws[0]["held_ns"] >= 5_000_000
    assert locktrack.violations() == []


def test_condition_wait_parked_time_is_not_billed(hold_warn):
    hold_warn(30)
    cv = threading.Condition(locktrack.make_lock("queuecv:hold:w"))
    with cv:
        cv.wait(timeout=0.1)  # lock released while parked
    assert locktrack.hold_warnings() == []
    fam = locktrack.hold_stats()["queuecv"]
    assert fam["count"] == 2  # the segments before and after the wait
    assert fam["max_ns"] < 30_000_000


# ---------------------------------------------------------------------------
# The port's broker under the detectors: zero violations
# ---------------------------------------------------------------------------


def _spec(colony, etype="worker", **kw):
    d = {"conditions": {"colonyname": colony, "executortype": etype},
         "funcname": "echo", "maxexectime": 60}
    d.update(kw)
    return d


@pytest.mark.parametrize("db", ["memory", "sqlite"])
def test_multithread_stress_runs_clean(all_checks, db):
    """submit/assign/close/addchild/failsafe across 2 colonies on the port's
    broker, every detector on. The server, its database and every lock in
    them are built while tracking is on, so each acquisition on every
    thread feeds the order graph and each request runs under the auth-fact
    contracts; nothing may fire."""
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    srv = standalone_server(Crypto.id(server_prv),
                            MemoryDatabase() if db == "memory" else SqliteDatabase())
    client = Colonies(InProcTransport([srv]))
    colonies = ("c1", "c2")
    for cname in colonies:
        client.add_colony(cname, Crypto.id(colony_prv), server_prv)
    srv.start_background(failsafe_interval=0.05)  # scans race the traffic below

    stop = threading.Event()
    errors: list[BaseException] = []

    def guard(fn):
        def run():
            try:
                while not stop.is_set():
                    fn()
            except BaseException as e:  # noqa: BLE001 — surfaced via `errors`
                errors.append(e)

        return run

    executors, threads = [], []
    for cname in colonies:
        for i in range(2):
            ex = ExecutorBase(client, cname, f"w{i}", "worker", colony_prvkey=colony_prv)
            n_children = [0]

            def echo(ctx, *args, _n=n_children):
                _n[0] += 1  # every few processes, grow the DAG from inside
                if _n[0] % 3 == 0 and not ctx.process.parents:
                    ctx.add_child(_spec(ctx.process.colonyname))
                return list(args)

            ex.register_function("echo", echo)
            executors.append(ex)
            threads.append(threading.Thread(target=guard(lambda e=ex: e.step(0.1))))

    def submitter(cname):
        def once():
            client.submit(_spec(cname, args=["x"]), colony_prv)
            # a short lease the failsafe resets or fails
            client.submit(_spec(cname, maxexectime=1, maxretries=0), colony_prv)
            # one nobody can run: its wait runs out
            client.submit(_spec(cname, etype="ghost", maxwaittime=1), colony_prv)
            time.sleep(0.01)

        return once

    for cname in colonies:
        threads.append(threading.Thread(target=guard(submitter(cname))))
    for t in threads:
        t.start()
    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    srv.stop()

    assert not errors, errors
    assert sum(ex.processed for ex in executors) > 0
    assert srv.failsafe_errors == 0
    assert locktrack.violations() == []
    fams = locktrack.hold_stats()
    want = {"queuecv", "signals"} | ({"shard", "glock"} if db == "memory" else {"sqlite",
                                                                                 "dbcolony"})
    assert want <= set(fams), sorted(fams)


def test_ha_failover_runs_clean(all_checks):
    """Three replicas in one process behind Raft (three ``raft:`` locks of
    one exclusive family): assign and close through the log, the leader
    partitioned away and brought back, every detector on; every process
    succeeds, the journals agree, and nothing fires."""
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    cluster = HAColonyCluster(Crypto.id(server_prv), replicas=3, seed=23)
    cluster.start(failsafe_interval=0.1)
    try:
        assert cluster.wait_for_leader(10)
        retry = RetryPolicy(base_s=0.01, cap_s=0.3, deadline_s=20.0, budget=64, seed=3)
        client = Colonies(InProcTransport(cluster.servers, retry=retry))
        client.add_colony("dev", Crypto.id(colony_prv), server_prv)
        ex = ExecutorBase(Colonies(InProcTransport(cluster.servers, retry=retry)), "dev",
                          "ha-w", "worker", colony_prvkey=colony_prv)
        ex.register_function("echo", lambda ctx, *a: list(a))
        ex.start(poll_timeout=0.3)
        try:
            p1 = client.submit(_spec("dev", args=[1]), colony_prv)
            assert client.wait(p1["processid"], colony_prv, timeout=10)["state"] == "successful"
            lid = cluster.raft.leader_id()
            cluster.kill_server(int(lid[1:]))
            p2 = client.submit(_spec("dev", args=[2]), colony_prv)
            assert client.wait(p2["processid"], colony_prv, timeout=20)["state"] == "successful"
            cluster.revive_server(int(lid[1:]))
        finally:
            ex.stop()
        cluster.raft.check_divergence()
        assert [s.failsafe_errors for s in cluster.servers] == [0, 0, 0]
    finally:
        cluster.stop()
    assert locktrack.violations() == []
    assert {"raft", "cluster", "applied", "assignlocal", "shard"} <= set(locktrack.hold_stats())
