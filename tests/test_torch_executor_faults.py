"""The port's client and ``ExecutorBase`` under RPC faults, against the
port's broker over both of its databases and its server-side fault sites
(``repro_torch.runtime.faults``).

The port's copies of ``tests/test_faults.py``'s exactly-once matrix for
submit, close and assign, and of its pending-close journal tests. A lost
request is the broker dying before dispatch (``server.pre_dispatch``), a
lost reply the broker dying after its commit (``server.post_commit``), and
a duplicate a transport that delivers every envelope twice."""

import time

import pytest

from repro_torch.broker import MemoryDatabase, SqliteDatabase, standalone_server
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.executor import ExecutorBase
from repro_torch.core.retry import RetryPolicy
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultPlan, FaultRule

SPEC = {"funcname": "echo", "conditions": {"colonyname": "dev", "executortype": "cli"}}

# A tight policy so injected faults retry in milliseconds, not seconds.
FAST_RETRY = RetryPolicy(base_s=0.001, cap_s=0.01, deadline_s=5.0, budget=8, seed=7)


class _TwiceTransport(InProcTransport):
    """At-least-once delivery made flesh: every envelope reaches the broker
    twice and the second reply is returned."""

    def _send_once(self, envelope: dict) -> dict:
        super()._send_once(envelope)
        return super()._send_once(envelope)


# fault -> (server-side rule, or None for the duplicating transport)
FAULTS = {
    "lost request": ("server.pre_dispatch", "crash"),
    "lost reply": ("server.post_commit", "crash"),
    "duplicate": None,
}


def _rig(db, fault):
    server_prv, colony_prv, exec_prv = Crypto.prvkey(), Crypto.prvkey(), Crypto.prvkey()
    srv = standalone_server(Crypto.id(server_prv), db)
    setup = Colonies(InProcTransport([srv], retry=FAST_RETRY))
    setup.add_colony("dev", Crypto.id(colony_prv), server_prv)
    setup.add_executor({"executorname": "e1", "executorid": Crypto.id(exec_prv),
                        "colonyname": "dev", "executortype": "cli"}, colony_prv)
    setup.approve_executor(Crypto.id(exec_prv), colony_prv)
    transport = _TwiceTransport if FAULTS[fault] is None else InProcTransport
    return srv, setup, Colonies(transport([srv], retry=FAST_RETRY)), exec_prv


@pytest.fixture(params=["memory", "sqlite"])
def db(request):
    return MemoryDatabase() if request.param == "memory" else SqliteDatabase()


def _plan(fault, ptype):
    rule = FAULTS[fault]
    return FaultPlan([FaultRule(*rule, payloadtype=ptype)] if rule else [])


def _fired(plan, fault):
    return plan.fired() == (0 if FAULTS[fault] is None else 1)


@pytest.mark.parametrize("fault", sorted(FAULTS))
class TestExactlyOnce:
    def test_submit_exactly_once(self, db, fault):
        srv, setup, client, prv = _rig(db, fault)
        with faults.active(_plan(fault, "submitfunctionspec")) as plan:
            p = client.submit(SPEC, prv)
        assert _fired(plan, fault)
        procs = setup.get_processes("dev", prv)
        assert [q["processid"] for q in procs] == [p["processid"]]
        srv.stop()

    def test_close_exactly_once(self, db, fault):
        srv, setup, client, prv = _rig(db, fault)
        p = setup.submit(SPEC, prv)
        assert setup.assign("dev", 2.0, prv)["processid"] == p["processid"]
        with faults.active(_plan(fault, "close")) as plan:
            closed = client.close(p["processid"], ["out"], prv)
        assert _fired(plan, fault)
        assert closed["state"] == "successful"
        final = setup.get_process(p["processid"], prv)
        assert final["state"] == "successful" and final["out"] == ["out"]
        stats = setup.stats("dev", prv)
        assert stats["successful"] == 1 and stats["failed"] == 0
        srv.stop()

    def test_assign_exactly_once(self, db, fault):
        srv, setup, client, prv = _rig(db, fault)
        p = setup.submit(SPEC, prv)
        with faults.active(_plan(fault, "assign")) as plan:
            a = client.assign("dev", 2.0, prv)
        assert _fired(plan, fault)
        assert a["processid"] == p["processid"]
        stats = setup.stats("dev", prv)
        assert stats["running"] == 1 and stats["waiting"] == 0
        srv.stop()


def _journal_rig():
    """A broker and a port executor whose client has NO transport retry."""
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    srv = standalone_server(Crypto.id(server_prv))
    client = Colonies(InProcTransport([srv]))
    client.add_colony("dev", Crypto.id(colony_prv), server_prv)
    ex = ExecutorBase(client, "dev", "worker", "cli", colony_prvkey=colony_prv)
    ex.register_function("echo", lambda ctx, *a: list(a))
    return srv, client, ex


class TestPendingCloseJournal:
    def test_close_journaled_and_flushed(self):
        srv, client, ex = _journal_rig()
        client.submit(dict(SPEC, args=[1]), ex.prvkey)
        # Every close attempt dies at the broker until the plan drains.
        plan = FaultPlan([FaultRule("server.pre_dispatch", "crash", payloadtype="close", times=2)])
        with faults.active(plan):
            assert ex.step(2.0)
        assert ex.processed == 0  # not yet delivered
        assert ex.flush_pending_closes(force=True) == 0
        assert ex.processed == 1
        p = client.get_processes("dev", ex.prvkey, state="successful")
        assert len(p) == 1 and p[0]["out"] == [1]
        srv.stop()

    def test_journal_reuses_msgid_no_conflict(self):
        """The first close COMMITS but its reply is lost; the journaled retry
        must replay via dedup instead of raising ConflictError."""
        srv, client, ex = _journal_rig()
        client.submit(dict(SPEC, args=[2]), ex.prvkey)
        plan = FaultPlan([FaultRule("server.post_commit", "crash", payloadtype="close", times=1)])
        with faults.active(plan):
            ex.step(2.0)
        assert plan.fired() == 1 and ex.processed == 0
        assert ex.flush_pending_closes(force=True) == 0
        assert ex.processed == 1 and ex.failed == 0
        assert client.stats("dev", ex.prvkey)["successful"] == 1
        srv.stop()

    def test_stop_drains_journal(self):
        srv, client, ex = _journal_rig()
        client.submit(dict(SPEC, args=[3]), ex.prvkey)
        plan = FaultPlan([FaultRule("server.pre_dispatch", "crash", payloadtype="close", times=3)])
        with faults.active(plan):
            ex.step(2.0)
            assert ex.processed == 0
            ex.stop()  # graceful drain delivers the journaled close
        assert ex.processed == 1
        assert client.stats("dev", ex.prvkey)["successful"] == 1
        srv.stop()


class _CountingDownTransport:
    """Permanently down: every send fails retryably, counting calls."""

    def __init__(self):
        self.calls = 0

    def send(self, envelope, timeout=None):
        self.calls += 1
        return {"error": "transport: connection refused", "status": 503}


def test_run_forever_backs_off_from_a_dead_broker(monkeypatch):
    # no broker reads these envelopes, so signing (~80 ms each in pure
    # Python) is stubbed out: the count below then measures the backoff
    import repro_torch.core.client as client_mod

    monkeypatch.setattr(client_mod, "sign_envelope",
                        lambda ptype, payload, prvkey, msgid=None: {"payloadtype": ptype})
    transport = _CountingDownTransport()
    ex = ExecutorBase(Colonies(transport), "dev", "worker", "cli")
    ex.start(poll_timeout=0.01)
    time.sleep(0.6)
    ex.stop()
    assert not ex._thread.is_alive()
    # a fixed 0.05 s wait would allow ~12 calls in 0.6 s; the capped
    # exponential backoff (0.05 * 2^n, jittered) stays well under that
    assert 1 <= transport.calls <= 7, transport.calls
    assert ex._error_backoff(1) <= 0.05
    assert ex._error_backoff(100) <= 2.0  # PENDING_BACKOFF_CAP_S
