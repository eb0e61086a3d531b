"""The port's fault plane (``repro_torch.runtime.faults``) against the
reference's ``repro.runtime.faults``, and the port's client and
``ExecutorBase`` under RPC faults behind the port's own broker, standalone
and replicated.

The same rules and seed give the same schedule: a scripted stream of hits
with context fires the same (site, action) at the same hits in both
packages. Then the exactly-once matrix of ``tests/test_faults.py`` and the
pending-close journal of ``tests/test_torch_executor_faults.py`` run with
the port's fault sites (client transports, the broker's crash windows)
against ``standalone_server`` and a three-replica ``HAColonyCluster``."""

import numpy as np
import pytest

from repro.runtime import faults as ref_faults
from repro_torch.broker import HAColonyCluster, standalone_server
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.executor import ExecutorBase
from repro_torch.core.retry import RetryPolicy
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultPlan, FaultRule

SPEC = {"funcname": "echo", "conditions": {"colonyname": "dev", "executortype": "cli"}}
FAST_RETRY = RetryPolicy(base_s=0.001, cap_s=0.01, deadline_s=5.0, budget=8, seed=7)

# every option of a rule: after, times, prob, match and payloadtype
RULES = [
    dict(site="transport.send", action="drop", payloadtype="close", after=3, times=5),
    dict(site="transport.send", action="duplicate", times=None, prob=0.3),
    dict(site="raft.tick", action="delay", delay_s=0.0, times=None, prob=0.5),
    dict(site="blob.get", action="crash", match={"shard": 1}, after=2, times=None),
    dict(site="blob.put", action="crash", match={"shard": 2, "key": "k3"}, times=4),
    dict(site="transport.recv", action="reset", times=10, prob=0.7),
    dict(site="server.post_commit", action="crash", payloadtype="submitfunctionspec", times=2),
    dict(site="server.pre_dispatch", action="reset", payloadtype="assign", after=1, times=3,
         prob=0.5),
    dict(site="db.commit", action="crash", match={"method": "update_process"}, times=None),
]
PTYPES = ["close", "assign", "submitfunctionspec", "colonystats", ""]


def _stream(n: int, seed: int) -> list[tuple[str, dict]]:
    """``n`` hits at random sites with random context."""
    rng = np.random.default_rng(seed)
    sites = sorted(faults.SITES)
    out = []
    for _ in range(n):
        site = sites[rng.integers(len(sites))]
        if site.startswith("blob."):
            ctx = {"shard": int(rng.integers(3)), "key": f"k{rng.integers(5)}"}
        elif site == "db.commit":
            ctx = {"method": ["add_process", "update_process"][rng.integers(2)]}
        elif site == "raft.tick":
            ctx = {}
        else:
            ctx = {"payloadtype": PTYPES[rng.integers(len(PTYPES))]}
        out.append((site, ctx))
    return out


def _schedule(mod, hits, seed: int) -> tuple[list, list, list]:
    plan = mod.FaultPlan([mod.FaultRule(**r) for r in RULES], seed=seed)
    outcomes = []
    with mod.active(plan):
        for site, ctx in hits:
            try:
                outcomes.append((site, mod.hit(site, **ctx)))
            except mod.FaultInjected:
                outcomes.append((site, "raised"))
    assert mod.current() is None
    return outcomes, plan.log, [(r.matched, r.fired) for r in plan.rules]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_schedule_equals_the_reference(seed):
    hits = _stream(1000, seed)
    ours, theirs = _schedule(faults, hits, seed), _schedule(ref_faults, hits, seed)
    assert ours == theirs
    outcomes, log, counters = ours
    # every rule matched, and each kind of outcome happened
    assert all(m > 0 for m, _ in counters) and all(f > 0 for _, f in counters)
    assert {o for _, o in outcomes} == {None, "raised", "duplicate"}
    assert len(log) == sum(f for _, f in counters)


def _activation(mod) -> list:
    """What installing, nesting and leaving a plan does, step by step."""
    seen = []
    outer, inner = mod.FaultPlan(), mod.FaultPlan()
    seen.append(mod.current() is None)
    with mod.active(outer):
        seen.append(mod.current() is outer)
        try:
            with mod.active(inner):
                seen.append("nested")
        except RuntimeError as e:
            seen.append(type(e).__name__)
        seen.append(mod.current() is outer)  # the outer plan stays installed
    seen.append(mod.current() is None)
    try:
        with mod.active(outer):
            raise KeyError("inside")
    except KeyError:
        seen.append(mod.current() is None)  # restored on an exception too
    for bad in (dict(site="nonexistent.site", action="drop"),
                dict(site="db.commit", action="explode")):
        try:
            mod.FaultRule(**bad)
        except ValueError:
            seen.append("ValueError")
    seen.append(mod.hit("transport.send") is None)  # zero cost when unset
    return seen


def test_active_nests_and_restores_as_the_reference():
    assert _activation(faults) == _activation(ref_faults)
    assert _activation(faults) == [True, True, "RuntimeError", True, True, True,
                                   "ValueError", "ValueError", True]


# ---------------------------------------------------------------------------
# The exactly-once matrix behind the port's broker, standalone and HA
# ---------------------------------------------------------------------------

FAULTS = {
    "drop": ("transport.send", "drop"),  # request lost before the broker saw it
    "duplicate": ("transport.send", "duplicate"),  # delivered twice
    "reset": ("transport.recv", "reset"),  # reply lost after the commit
    "crash": ("server.post_commit", "crash"),  # broker dies after commit, before reply
    "lost request": ("server.pre_dispatch", "crash"),  # broker dies before dispatch
}


class _Deployment:
    """The port's broker, one replica or three behind Raft, with a colony,
    an approved executor key and a client over every replica."""

    def __init__(self, kind: str):
        server_prv, self.colony_prv, self.exec_prv = (Crypto.prvkey(), Crypto.prvkey(),
                                                       Crypto.prvkey())
        if kind == "ha":
            self.cluster = HAColonyCluster(Crypto.id(server_prv), replicas=3, seed=21)
            self.cluster.start(failsafe_interval=0.1)
            assert self.cluster.wait_for_leader(10)
            self.servers = self.cluster.servers
        else:
            self.cluster = None
            self.servers = [standalone_server(Crypto.id(server_prv))]
        self.client = Colonies(InProcTransport(self.servers, retry=FAST_RETRY))
        self.client.add_colony("dev", Crypto.id(self.colony_prv), server_prv)

    def add_executor(self) -> None:
        self.client.add_executor({"executorname": "e1", "executorid": Crypto.id(self.exec_prv),
                                  "colonyname": "dev", "executortype": "cli"}, self.colony_prv)
        self.client.approve_executor(Crypto.id(self.exec_prv), self.colony_prv)

    def stop(self) -> None:
        if self.cluster is not None:
            self.cluster.raft.check_divergence()
            self.cluster.stop()
        else:
            self.servers[0].stop()


@pytest.fixture(params=["standalone", "ha"])
def deployment(request):
    d = _Deployment(request.param)
    yield d
    d.stop()


def _plan(fault, ptype):
    return FaultPlan([FaultRule(*FAULTS[fault], payloadtype=ptype)])


@pytest.mark.parametrize("fault", sorted(FAULTS))
class TestExactlyOnce:
    def test_submit_exactly_once(self, deployment, fault):
        d = deployment
        d.add_executor()
        with faults.active(_plan(fault, "submitfunctionspec")) as plan:
            p = d.client.submit(SPEC, d.exec_prv)
        assert plan.fired() == 1
        procs = d.client.get_processes("dev", d.exec_prv)
        assert [q["processid"] for q in procs] == [p["processid"]]

    def test_close_exactly_once(self, deployment, fault):
        d = deployment
        d.add_executor()
        p = d.client.submit(SPEC, d.exec_prv)
        assert d.client.assign("dev", 2.0, d.exec_prv)["processid"] == p["processid"]
        with faults.active(_plan(fault, "close")) as plan:
            closed = d.client.close(p["processid"], ["out"], d.exec_prv)
        assert plan.fired() == 1
        assert closed["state"] == "successful"
        final = d.client.get_process(p["processid"], d.exec_prv)
        assert final["state"] == "successful" and final["out"] == ["out"]
        stats = d.client.stats("dev", d.exec_prv)
        assert stats["successful"] == 1 and stats["failed"] == 0

    def test_assign_exactly_once(self, deployment, fault):
        d = deployment
        d.add_executor()
        p = d.client.submit(SPEC, d.exec_prv)
        with faults.active(_plan(fault, "assign")) as plan:
            a = d.client.assign("dev", 2.0, d.exec_prv)
        assert plan.fired() == 1
        assert a["processid"] == p["processid"]
        stats = d.client.stats("dev", d.exec_prv)
        assert stats["running"] == 1 and stats["waiting"] == 0


# The pending-close journal: the executor's client has no transport retry,
# so one pass over the replicas is one delivery attempt. A pass tries every
# replica in turn, so a rule that kills "every attempt" fires once per
# replica and attempt.


def _journal_rig(d: _Deployment) -> ExecutorBase:
    ex = ExecutorBase(Colonies(InProcTransport(d.servers)), "dev", "worker", "cli",
                      colony_prvkey=d.colony_prv)
    ex.register_function("echo", lambda ctx, *a: list(a))
    return ex


class TestPendingCloseJournal:
    def test_close_journaled_and_flushed(self, deployment):
        d = deployment
        ex = _journal_rig(d)
        d.client.submit(dict(SPEC, args=[1]), ex.prvkey)
        plan = FaultPlan([FaultRule("server.pre_dispatch", "crash", payloadtype="close",
                                    times=2 * len(d.servers))])
        with faults.active(plan):
            assert ex.step(2.0)
        assert ex.processed == 0  # not yet delivered
        assert ex.flush_pending_closes(force=True) == 0
        assert ex.processed == 1
        p = d.client.get_processes("dev", ex.prvkey, state="successful")
        assert len(p) == 1 and p[0]["out"] == [1]

    def test_journal_reuses_msgid_no_conflict(self, deployment):
        """The first close commits but its reply is lost (and the other
        replicas of the pass die before dispatch); the journaled retry
        must replay through the dedup table, not raise ConflictError."""
        d = deployment
        ex = _journal_rig(d)
        d.client.submit(dict(SPEC, args=[2]), ex.prvkey)
        rules = [FaultRule("server.post_commit", "crash", payloadtype="close", times=1)]
        if len(d.servers) > 1:
            rules.append(FaultRule("server.pre_dispatch", "crash", payloadtype="close",
                                   after=1, times=len(d.servers) - 1))
        plan = FaultPlan(rules)
        with faults.active(plan):
            ex.step(2.0)
        assert plan.fired("server.post_commit") == 1 and ex.processed == 0
        assert ex.flush_pending_closes(force=True) == 0
        assert ex.processed == 1 and ex.failed == 0
        assert d.client.stats("dev", ex.prvkey)["successful"] == 1

    def test_stop_drains_journal(self, deployment):
        d = deployment
        ex = _journal_rig(d)
        d.client.submit(dict(SPEC, args=[3]), ex.prvkey)
        plan = FaultPlan([FaultRule("server.pre_dispatch", "crash", payloadtype="close",
                                    times=3 * len(d.servers))])
        with faults.active(plan):
            ex.step(2.0)
            assert ex.processed == 0
            ex.stop()  # graceful drain delivers the journaled close
        assert ex.processed == 1
        assert d.client.stats("dev", ex.prvkey)["successful"] == 1
