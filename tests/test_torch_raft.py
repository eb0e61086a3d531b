"""The port's Raft (``repro_torch.broker.raft``) against the reference's
``repro.core.raft``: with the same seed, the simulated clusters take the
same elections step for step under one scripted schedule of steps, kills,
revives, partitions, message loss and proposals (same leaders per term,
logs, commit indexes and applied sequences after every event). Then the
cases of ``tests/test_raft.py``, run on the port."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.raft import SimRaftCluster as RefSimRaftCluster
from repro_torch.broker.raft import SimRaftCluster


def _schedule(n: int, seed: int, events: int = 900) -> list[tuple]:
    """A seeded script: mostly 10-ms steps, now and then a kill, a revive,
    a one-link partition, a heal, a change of message loss or a proposal
    on every node that believes it leads."""
    rng = np.random.default_rng(1000 + seed)
    nodes = [f"n{i}" for i in range(n)]
    out = []
    for i in range(events):
        r = rng.random()
        if r < 0.015:
            out.append(("kill", nodes[rng.integers(n)]))
        elif r < 0.03:
            out.append(("revive", nodes[rng.integers(n)]))
        elif r < 0.04:
            a, b = rng.choice(n, 2, replace=False)
            out.append(("partition", nodes[a], nodes[b]))
        elif r < 0.045:
            out.append(("heal",))
        elif r < 0.05:
            out.append(("drop", float(rng.choice([0.0, 0.1, 0.3]))))
        elif r < 0.12:
            out.append(("propose", {"v": i, "op": "assign"}))
        else:
            out.append(("step", int(rng.choice([10, 10, 10, 30]))))
    return out


def _run(cls, n: int, seed: int, script: list[tuple]) -> list:
    applied: dict[str, list] = {}
    sim = cls(n, apply_fn=lambda nid, e, i: applied.setdefault(nid, []).append((i, e["v"])),
              seed=seed)
    states = []
    for ev in script:
        kind = ev[0]
        if kind == "step":
            sim.step(ev[1])
        elif kind == "kill":
            sim.kill(ev[1])
        elif kind == "revive":
            sim.revive(ev[1])
        elif kind == "partition":
            sim.net.partition(ev[1], ev[2])
        elif kind == "heal":
            sim.net.heal()
        elif kind == "drop":
            sim.net.drop_prob = ev[1]
        else:
            for nid in sim.leaders():
                sim.nodes[nid].propose(dict(ev[1], by=nid))
        states.append((
            sim.now_ms,
            sim.leaders_of_term(),
            {nid: (node.current_term, node.state, node.voted_for, node.commit_index,
                   node.last_applied, [le.to_dict() for le in node.log])
             for nid, node in sim.nodes.items()},
            {nid: list(seq) for nid, seq in applied.items()},
            (sim.net.delivered, sim.net.dropped),
        ))
    return states


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("seed", range(8))
def test_elections_and_logs_equal_the_reference_step_for_step(seed, n):
    script = _schedule(n, seed)
    ours, theirs = _run(SimRaftCluster, n, seed, script), _run(RefSimRaftCluster, n, seed, script)
    assert len(ours) == len(theirs) == len(script)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, f"seed {seed}, {n} nodes: the clusters differ after event {i} {script[i]}"
    # the script exercised elections, commits and more than one term
    terms = {t for s in ours for t in s[1]}
    assert len(terms) >= 2
    assert max(node[3] for node in ours[-1][2].values()) >= 3


# ---------------------------------------------------------------------------
# tests/test_raft.py on the port
# ---------------------------------------------------------------------------


def test_single_leader_elected():
    sim = SimRaftCluster(3, seed=1)
    leader = sim.run_until_leader()
    assert leader is not None
    assert len(sim.leaders()) == 1


def test_failover_elects_new_leader():
    sim = SimRaftCluster(3, seed=2)
    l1 = sim.run_until_leader()
    sim.kill(l1)
    for _ in range(600):
        sim.step()
        fresh = [l for l in sim.leaders() if l != l1]
        if fresh:
            break
    assert fresh, "no new leader after killing the old one"


def test_partitioned_leader_steps_down():
    """Check-quorum: a leader cut off from the majority must not keep
    serving assigns (it would double-assign)."""
    sim = SimRaftCluster(3, seed=3)
    l1 = sim.run_until_leader()
    sim.kill(l1)
    for _ in range(800):
        sim.step()
    assert not sim.nodes[l1].is_leader(), "stale leader kept leadership"


def test_heal_rejoins_cluster():
    sim = SimRaftCluster(3, seed=4)
    l1 = sim.run_until_leader()
    sim.kill(l1)
    for _ in range(600):
        sim.step()
    sim.revive(l1)
    for _ in range(600):
        sim.step()
    leaders = sim.leaders()
    assert len(leaders) == 1
    # the revived node recognises the current term's leader
    terms = {n.current_term for n in sim.nodes.values()}
    assert len(terms) == 1


def test_log_replication_and_apply():
    applied: dict[str, list] = {}
    sim = SimRaftCluster(
        3, apply_fn=lambda nid, e, i: applied.setdefault(nid, []).append((i, e["v"])),
        seed=5,
    )
    leader = sim.run_until_leader()
    for v in range(5):
        assert sim.nodes[leader].propose({"v": v}) is not None
        for _ in range(20):
            sim.step()
    # all nodes applied the same sequence
    seqs = {nid: tuple(v) for nid, v in applied.items()}
    assert len(seqs) == 3
    assert len(set(seqs.values())) == 1
    assert [v for _, v in applied[leader]] == [0, 1, 2, 3, 4]


def test_committed_entries_survive_failover():
    applied: dict[str, list] = {}
    sim = SimRaftCluster(
        3, apply_fn=lambda nid, e, i: applied.setdefault(nid, []).append(e["v"]),
        seed=6,
    )
    l1 = sim.run_until_leader()
    sim.nodes[l1].propose({"v": "committed"})
    for _ in range(60):
        sim.step()
    sim.kill(l1)
    for _ in range(800):
        sim.step()
    l2 = [l for l in sim.leaders() if l != l1]
    assert l2, "no new leader"
    sim.nodes[l2[0]].propose({"v": "after-failover"})
    for _ in range(60):
        sim.step()
    assert applied[l2[0]] == ["committed", "after-failover"]


def test_non_leader_refuses_proposals():
    sim = SimRaftCluster(3, seed=7)
    leader = sim.run_until_leader()
    for nid, node in sim.nodes.items():
        assert (node.propose({"v": 0}) is None) == (nid != leader)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000), drop=st.floats(0.0, 0.3))
def test_property_election_safety_under_message_loss(seed, drop):
    """At most one leader per term, even with lossy links."""
    sim = SimRaftCluster(5, seed=seed)
    sim.net.drop_prob = drop
    leaders_by_term: dict[int, set[str]] = {}
    for _ in range(400):
        sim.step()
        for term, ls in sim.leaders_of_term().items():
            leaders_by_term.setdefault(term, set()).update(ls)
    for term, ls in leaders_by_term.items():
        assert len(ls) <= 1, f"two leaders in term {term}: {ls}"
