"""``tests/test_chaos_soak.py`` on the port's replicated broker, in process
and over three HTTP servers, with the digest check armed: the HA fault
matrix (a reply lost after the commit is replayed, not re-proposed) and
the soak (a seeded probabilistic FaultPlan and a ChaosMonkey partitioning
one replica at a time; every process ends exactly once, no divergence)."""

import threading
import time

from repro_torch.core.executor import ExecutorBase
from repro_torch.runtime import faults
from repro_torch.runtime.chaos import ChaosMonkey
from test_torch_ha import _Rig, repl_check, spec, via  # noqa: F401 (fixtures)

N_PROCESSES = 24
SOAK_DEADLINE_S = 45.0


class TestHAFaultMatrix:
    """Reset-after-commit-before-reply against the replicated broker: the
    retry must replay the recorded reply (not re-propose the op), and the
    double-apply digest harness must stay clean."""

    def test_submit_reply_lost_yields_one_process(self, repl_check, via):
        rig = _Rig(via, seed=31)
        try:
            plan = faults.FaultPlan([faults.FaultRule("transport.recv", "reset",
                                                      payloadtype="submitfunctionspec")])
            with faults.active(plan):
                p = rig.client.submit(spec([1], maxretries=3), rig.colony_prv)
            assert plan.fired() == 1
            procs = rig.client.get_processes("dev", rig.colony_prv)
            assert [q["processid"] for q in procs] == [p["processid"]]
            rig.cluster.raft.check_divergence()
        finally:
            rig.stop()

    def test_close_reply_lost_closes_exactly_once(self, repl_check, via):
        rig = _Rig(via, seed=31)
        try:
            ex = ExecutorBase(rig.new_client(), "dev", "m-w", "worker",
                              colony_prvkey=rig.colony_prv)
            p = rig.client.submit(spec([1]), rig.colony_prv)
            assert ex.client.assign("dev", 5.0, ex.prvkey)["processid"] == p["processid"]
            plan = faults.FaultPlan([faults.FaultRule("transport.recv", "reset",
                                                      payloadtype="close")])
            with faults.active(plan):
                # the retry gets the recorded reply, not a ConflictError
                ex.client.close(p["processid"], ["out"], ex.prvkey)
            assert plan.fired() == 1
            done = rig.client.get_process(p["processid"], rig.colony_prv)
            assert done["state"] == "successful" and done["out"] == ["out"]
            rig.cluster.raft.check_divergence()
            # one close entry in the Raft log, with the client's msgid
            lid = rig.cluster.raft.leader_id()
            closes = [le.entry for le in rig.cluster.raft.nodes[lid].log
                      if le.entry.get("op") == "close"]
            assert len(closes) == 1 and closes[0]["msgid"]
        finally:
            rig.stop()


def test_chaos_soak_every_process_terminal_exactly_once(repl_check, via):
    """tests/test_chaos_soak.py's soak on the port: a seeded probabilistic
    FaultPlan (lost replies, lost requests) and a ChaosMonkey partitioning
    one replica at a time, two retrying executors, the digest check armed."""
    rig = _Rig(via, seed=31)
    cluster, client, colony_prv = rig.cluster, rig.client, rig.colony_prv
    plan = faults.FaultPlan([
        faults.FaultRule("transport.recv", "reset", times=None, prob=0.08),
        faults.FaultRule("transport.send", "drop", times=None, prob=0.04),
    ], seed=1234)
    state = {"down": None, "next": 0}
    guard = threading.Lock()

    def kill():
        with guard:
            if state["down"] is not None:
                cluster.revive_server(state["down"])
            state["down"] = state["next"]
            state["next"] = (state["next"] + 1) % 3
            cluster.kill_server(state["down"])

    monkey = ChaosMonkey(kill, lambda: None, interval=(0.6, 1.2), seed=5)
    executors = [ExecutorBase(rig.new_client(), "dev", f"soak-{i}", "worker",
                              colony_prvkey=colony_prv) for i in range(2)]
    for ex in executors:
        ex.register_function("echo", lambda ctx, *a: list(a))
    pids = []
    try:
        with faults.active(plan):
            for ex in executors:
                ex.start(poll_timeout=0.3)
            monkey.start()
            try:
                for i in range(N_PROCESSES):
                    pids.append(client.submit(spec([i], maxexectime=5, maxretries=3),
                                              colony_prv)["processid"])
                deadline = time.time() + SOAK_DEADLINE_S
                remaining = set(pids)
                while remaining and time.time() < deadline:
                    remaining -= {pid for pid in remaining if client.get_process(
                        pid, colony_prv)["state"] in ("successful", "failed")}
                    if remaining:
                        time.sleep(0.2)
            finally:
                monkey.stop()
                with guard:
                    if state["down"] is not None:
                        cluster.revive_server(state["down"])
                        state["down"] = None
                for ex in executors:
                    ex.stop()
        assert not remaining, (f"{len(remaining)} of {N_PROCESSES} processes never ended "
                               f"(faults fired: {plan.fired()}, monkey kills: {monkey.kills})")
        procs = client.get_processes("dev", colony_prv)
        assert sorted(q["processid"] for q in procs) == sorted(pids)
        assert all(q["state"] in ("successful", "failed") for q in procs)
        assert plan.fired() >= 5 and monkey.kills >= 1
        journal = cluster.raft.journal
        assert journal is not None
        commit = max(n.commit_index for n in cluster.raft.nodes.values())
        catchup = time.time() + 20
        while time.time() < catchup:
            if all(n.last_applied >= commit for n in cluster.raft.nodes.values()):
                break
            time.sleep(0.05)
        cluster.raft.check_divergence()
        journal.check()
        assert client.stats("dev", colony_prv)["failsafe_errors"] == 0
    finally:
        rig.stop()
