"""The port's replicated broker (``repro_torch.broker.HAColonyCluster``,
paper §3.4.1, Fig. 3): three replicas over one shared database, Raft
electing the leader that serves ``assign`` and ``close``.

``tests/test_http_and_ha.py``' failover and exactly-once assignment run on
the port's cluster, in process and over three HTTP servers; one scripted
request sequence with a leader kill gets the same replies from the port's
cluster as from the reference's; and ``chip_smoke.py``'s replicated broker
process loads no torch and takes its harness commands. The fault matrix
and the soak are in ``tests/test_torch_chaos_soak.py``, training through a
failover in ``tests/test_torch_ha_train.py``."""

import json
import time

import pytest

from repro.core.cluster import HAColonyCluster as RefHAColonyCluster
from repro_torch.analysis import statehash
from repro_torch.broker import ColoniesHttpServer, HAColonyCluster, SqliteDatabase
from repro_torch.core import errors
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.executor import ExecutorBase
from repro_torch.core.http_transport import HttpTransport
from repro_torch.core.retry import RetryPolicy
from test_torch_broker import KEYS, _Numbering

# Generous budget/deadline: during a leader election every replica
# answers 421 for up to a second or two (tests/test_chaos_soak.py's)
SOAK_RETRY = RetryPolicy(base_s=0.01, cap_s=0.3, deadline_s=20.0, budget=64, seed=3)


def spec(args=None, **kw):
    return dict({"conditions": {"colonyname": "dev", "executortype": "worker"},
                 "funcname": "echo", "args": args or [], "maxexectime": 60}, **kw)


class _Rig:
    """A started three-replica cluster with a 'dev' colony, reached in
    process or over one HTTP server per replica, over ``db`` (the cluster's
    own ``MemoryDatabase`` when None)."""

    def __init__(self, via: str, seed: int, failsafe_interval: float = 0.2, db=None):
        self.server_prv, self.colony_prv = Crypto.prvkey(), Crypto.prvkey()
        self.cluster = HAColonyCluster(Crypto.id(self.server_prv), replicas=3, db=db, seed=seed)
        self.https = []
        if via == "http":
            self.https = [ColoniesHttpServer(s) for s in self.cluster.servers]
            for h in self.https:
                h.start()
        self.cluster.start(failsafe_interval=failsafe_interval)
        assert self.cluster.wait_for_leader(10)
        self.client = self.new_client()
        self.client.add_colony("dev", Crypto.id(self.colony_prv), self.server_prv)

    def new_client(self, retry: RetryPolicy | None = SOAK_RETRY) -> Colonies:
        """Each actor gets its own transport: retry state and the preferred
        replica are per connection, like real sockets."""
        if self.https:
            (h0, p0), rest = (self.https[0].host, self.https[0].port), self.https[1:]
            return Colonies(HttpTransport(h0, p0, fallbacks=[(h.host, h.port) for h in rest],
                                          retry=retry))
        return Colonies(InProcTransport(self.cluster.servers, retry=retry))

    def stop(self) -> None:
        self.cluster.stop()
        for h in self.https:
            h.stop()


@pytest.fixture()
def repl_check():
    prev = statehash.is_enabled()
    statehash.enable(True)
    yield
    statehash.enable(prev)


@pytest.fixture(params=["inproc", "http"])
def via(request):
    return request.param


def test_ha_cluster_failover(via):
    """Fig. 3: kill the leader replica; assigns keep working via failover,
    and every process is assigned exactly once (raft-serialized)."""
    rig = _Rig(via, seed=11, failsafe_interval=0.1)
    try:
        ex = ExecutorBase(rig.new_client(), "dev", "ha-w", "worker",
                          colony_prvkey=rig.colony_prv)
        ex.register_function("echo", lambda ctx, *a: list(a))
        ex.start(poll_timeout=0.3)
        p1 = rig.client.submit(spec([1]), rig.colony_prv)
        assert rig.client.wait(p1["processid"], rig.colony_prv, timeout=10)["state"] == \
            "successful"
        lid = rig.cluster.raft.leader_id()
        rig.cluster.kill_server(int(lid[1:]))
        p2 = rig.client.submit(spec([2]), rig.colony_prv)
        done = rig.client.wait(p2["processid"], rig.colony_prv, timeout=20)
        assert done["state"] == "successful" and done["out"] == [2]
        assert rig.cluster.raft.leader_id() != lid
        ex.stop()
    finally:
        rig.stop()


def test_ha_exactly_once_assignment(via):
    """Two executors racing on the same queue never get the same process."""
    _exactly_once(_Rig(via, seed=12))


def test_ha_exactly_once_assignment_over_sqlite(tmp_path):
    """The same race with the replicas sharing one ``SqliteDatabase`` file,
    as the paper's replicas share one Postgres."""
    _exactly_once(_Rig("inproc", seed=12, db=SqliteDatabase(str(tmp_path / "ha.db"))))


def _exactly_once(rig: "_Rig") -> None:
    try:
        seen: list[str] = []
        executors = [ExecutorBase(rig.new_client(), "dev", f"race-{i}", "worker",
                                  colony_prvkey=rig.colony_prv) for i in (1, 2)]
        for ex in executors:
            ex.register_function("echo", lambda ctx, pid: seen.append(pid) or [pid])
            ex.start(poll_timeout=0.3)
        pids = [rig.client.submit(spec([f"p{i}"]), rig.colony_prv)["processid"]
                for i in range(6)]
        for pid in pids:
            assert rig.client.wait(pid, rig.colony_prv, timeout=20)["state"] == "successful"
        for ex in executors:
            ex.stop()
        assert sorted(seen) == sorted(f"p{i}" for i in range(6))  # no duplicates
    finally:
        rig.stop()


# ---------------------------------------------------------------------------
# The same replies as the reference's cluster
# ---------------------------------------------------------------------------


def _ha_script(cluster, client: Colonies) -> list:
    """One signed request sequence with a leader kill, for either cluster."""
    log = []

    def call(fn, *args, **kwargs):
        try:
            log.append(fn(*args, **kwargs))
        except errors.ColoniesError as e:
            log.append({"error": type(e).__name__, "status": e.status})
        return log[-1]

    def spec_(etype, funcname="fn", **kw):
        return dict({"conditions": {"colonyname": "dev", "executortype": etype},
                     "funcname": funcname}, **kw)

    k, ident = KEYS, {n: Crypto.id(v) for n, v in KEYS.items()}
    colony = k["colony"]
    call(client.add_colony, "dev", ident["colony"], k["server"])
    for name, etype in (("ex-a", "h100-pod"), ("ex-e", "edge-data")):
        call(client.add_executor, {"executorname": name, "executorid": ident[name],
                                   "colonyname": "dev", "executortype": etype}, colony)
        call(client.approve_executor, ident[name], colony)
    low = call(client.submit, spec_("h100-pod", args=["low"]), colony)
    high = call(client.submit, spec_("h100-pod", args=["high"], priority=1), colony)
    call(client.assign, "dev", 2.0, k["ex-a"])
    call(client.close, high["processid"], ["h"], k["ex-e"])  # not its executor: 403
    call(client.close, high["processid"], ["h"], k["ex-a"])
    call(client.close, high["processid"], ["h"], k["ex-a"])  # closed already: 409
    leader = cluster.raft.leader_id()
    cluster.kill_server(int(leader[1:]))
    # served through the failover: the killed leader steps down, a new one
    # is elected, the client's retry policy rides it out
    call(client.assign, "dev", 5.0, k["ex-a"])
    log.append(cluster.raft.leader_id() not in (None, leader))
    call(client.fail, low["processid"], ["boom"], k["ex-a"])
    wf = call(client.submit_workflow, {"colonyname": "dev", "functionspecs": [
        {"nodename": "prep", "funcname": "prepare_data",
         "conditions": {"executortype": "edge-data", "dependencies": []}},
        {"nodename": "train", "funcname": "train",
         "conditions": {"executortype": "h100-pod", "dependencies": ["prep"]}}]}, colony)
    call(client.assign, "dev", 0.05, k["ex-a"])  # train waits for prep: 408
    prep = call(client.assign, "dev", 5.0, k["ex-e"])
    call(client.close, prep["processid"], [1, 2], k["ex-e"])
    cluster.revive_server(int(leader[1:]))
    train = call(client.assign, "dev", 5.0, k["ex-a"])
    call(client.close, train["processid"], [3], k["ex-a"])
    call(client.get_process, wf["processes"][1]["processid"], colony)
    first = call(client._rpc, "submitfunctionspec", {"spec": spec_("nobody")}, colony,
                 msgid="cd" * 32)
    again = call(client._rpc, "submitfunctionspec", {"spec": spec_("nobody")}, colony,
                 msgid="cd" * 32)
    log.append(first == again)
    call(client.get_processes, "dev", colony, count=100)
    call(client.stats, "dev", colony)
    return log


def test_replies_through_a_leader_kill_equal_the_reference_cluster():
    server_id = Crypto.id(KEYS["server"])
    got = want = None
    for cls in (HAColonyCluster, RefHAColonyCluster):
        cluster = cls(server_id, replicas=3, seed=41)
        cluster.start(failsafe_interval=0.1)
        try:
            assert cluster.wait_for_leader(10)
            log = _ha_script(cluster, Colonies(InProcTransport(cluster.servers,
                                                               retry=SOAK_RETRY)))
        finally:
            cluster.stop()
        if cls is HAColonyCluster:
            got = log
        else:
            want = log
    got, want = _Numbering()(got), _Numbering()(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"reply {i}: {json.dumps(a)} != {json.dumps(b)}"
    assert got[-1]["successful"] == 3 and got[-1]["failed"] == 1
    assert got[12] is True  # the leader changed before the assign was served


def test_replicated_broker_process_loads_no_torch_and_takes_harness_commands():
    """``chip_smoke.py``'s replicated broker process: the new modules load
    neither torch, nor jax, nor the reference; a kill moves the leader."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    ha = chip_smoke.HABroker()
    try:
        assert ha.info["refuses_unsigned"] is True and ha.info["leader"] is not None
        assert ha.info["torch_or_jax"] == [] and ha.info["reference"] == []
        assert len(ha.ports) == 3
        ha.client.add_colony("dev", Crypto.id(ha.colony_prv), ha.server_prv)
        assert ha.client.stats("dev", ha.colony_prv)["blob"]["stores"] == 0
        before = ha.leader()
        ha.command(f"kill {before}")
        deadline = time.time() + 10
        while time.time() < deadline and ha.command("leader")["leader"] in (None, f"n{before}"):
            time.sleep(0.05)
        st = ha.stats()
        assert st["leader"] not in (None, f"n{before}")
        assert st["failover"]["killed"] == before and st["failover"]["elected_s"] > 0
        ha.command(f"revive {before}")
        assert ha.alive()
        rep = ha.report("[ha]", ("shard", "glock", "raft", "cluster"))
        assert rep["lock_check"] and rep["auth_check"] and rep["repl_check"]
        assert rep["violations"] == [] and rep["contract_errors"] == []
    finally:
        ha.close()
    assert not ha.alive()
