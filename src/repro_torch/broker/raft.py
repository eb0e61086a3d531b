"""Raft consensus (paper §3.4.1, after Ongaro & Ousterhout).

The paper uses Raft to elect a single Colonies server replica as leader:
only the leader serves ``assign`` (the one synchronized request) and runs
the cron/generator scanners. We implement a compact but real Raft —
randomized election timeouts, RequestVote/AppendEntries, log replication,
majority commit — over an abstract message-passing network so tests can
drive it deterministically (virtual clock, message drops, partitions)
and the HA cluster can drive it in real time.

Entries are opaque dicts; on commit every node invokes ``apply_fn(entry,
index)``. The cluster layer registers an idempotent apply (shared-DB
deployment, as in the paper's shared-Postgres architecture), so replay
on leader change is safe.

A copy of the reference's ``repro/core/raft.py``, stdlib only: the same
messages, timeouts and per-node seeds, so that with the same seed its
simulated cluster takes the reference's elections step for step. Its
locks come from ``analysis.locktrack.make_lock`` (``raft:<node>``,
``cluster``), and ``propose_and_wait`` declares ``@no_locks_held`` for
the database's families, as the reference's do.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

from ..analysis import statehash
from ..analysis.contracts import no_locks_held
from ..analysis.locktrack import allow_wait, make_lock
from ..core.errors import NotLeaderError, TimeoutError_
from ..runtime import faults

# propose_and_wait parks on a node's commit_cv (built on the raft lock)
# while the HA assign path still holds the leader-local assignlocal lock
# — the one hold its contract permits. Deadlock-free: commit_cv is
# notified from the event-loop thread (_apply_committed / _step_down),
# which never acquires assignlocal; the parked hold only serializes
# same-colony assigns, which is assignlocal's whole job.
allow_wait("raft", "assignlocal")


def _node_seed(node_id: str) -> int:
    """Deterministic per-node RNG seed. ``hash(str)`` is salted per
    process (PYTHONHASHSEED), so two identically-configured runs would
    draw different election jitter; CRC32 is stable everywhere."""
    return zlib.crc32(node_id.encode("utf-8"))

# RaftNode's default election timeout, drawn per node from this range, and
# propose_and_wait's default commit timeout: together they bound what a
# failover adds to an operation proposed on a partitioned leader
ELECTION_TIMEOUT_MS: tuple[int, int] = (150, 300)
COMMIT_TIMEOUT_S = 5.0

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


@dataclass
class LogEntry:
    term: int
    entry: dict

    def to_dict(self) -> dict:
        return {"term": self.term, "entry": self.entry}


@dataclass
class Msg:
    src: str
    dst: str
    kind: str  # request_vote | vote_reply | append_entries | append_reply
    body: dict = field(default_factory=dict)


class RaftNode:
    def __init__(
        self,
        node_id: str,
        peers: list[str],
        send: Callable[[Msg], None],
        apply_fn: Callable[[dict, int], None] | None = None,
        rng: random.Random | None = None,
        election_timeout_ms: tuple[int, int] = ELECTION_TIMEOUT_MS,
        heartbeat_ms: int = 50,
    ) -> None:
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self._send = send
        self.apply_fn = apply_fn or (lambda e, i: None)
        self.rng = rng or random.Random(_node_seed(node_id))
        self.election_timeout_ms = election_timeout_ms
        self.heartbeat_ms = heartbeat_ms

        # Persistent state
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[LogEntry] = []

        # Volatile state
        self.state = FOLLOWER
        self.commit_index = -1
        self.last_applied = -1
        self.leader_hint: str | None = None
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self._votes: set[str] = set()
        self._last_heard_ms = 0
        self._last_heartbeat_ms = 0
        self._timeout_ms = self._new_timeout()
        self._peer_contact_ms: dict[str, int] = {}
        self.lock = make_lock(f"raft:{node_id}")
        # Notified on every commit apply and on step-down, so a
        # propose_and_wait parks here instead of polling (see
        # ThreadedRaftCluster.propose_and_wait).
        self.commit_cv = threading.Condition(self.lock)

    # ------------------------------------------------------------------ util
    def _new_timeout(self) -> int:
        lo, hi = self.election_timeout_ms
        return self.rng.randint(lo, hi)

    def last_log_index(self) -> int:
        return len(self.log) - 1

    def last_log_term(self) -> int:
        return self.log[-1].term if self.log else 0

    def is_leader(self) -> bool:
        with self.lock:
            return self.state == LEADER

    # ------------------------------------------------------------------ time
    def tick(self, now_ms: int) -> None:
        with self.lock:
            if self.state == LEADER:
                # Check-quorum: a partitioned leader that cannot reach a
                # majority steps down, so stale leaders never serve assigns.
                if self.peers:
                    window = 2 * self.election_timeout_ms[1]
                    heard = 1 + sum(
                        1
                        for p in self.peers
                        if now_ms - self._peer_contact_ms.get(p, now_ms) <= window
                    )
                    if heard * 2 <= len(self.peers) + 1:
                        self._step_down(self.current_term)
                        self._last_heard_ms = now_ms
                        return
                if now_ms - self._last_heartbeat_ms >= self.heartbeat_ms:
                    self._broadcast_append(now_ms)
            else:
                if now_ms - self._last_heard_ms >= self._timeout_ms:
                    self._start_election(now_ms)

    def _start_election(self, now_ms: int) -> None:
        self.state = CANDIDATE
        self.current_term += 1
        self.voted_for = self.id
        self._votes = {self.id}
        self._last_heard_ms = now_ms
        self._timeout_ms = self._new_timeout()
        for p in self.peers:
            self._send(
                Msg(
                    self.id,
                    p,
                    "request_vote",
                    {
                        "term": self.current_term,
                        "candidate": self.id,
                        "last_log_index": self.last_log_index(),
                        "last_log_term": self.last_log_term(),
                    },
                )
            )
        self._maybe_win()  # single-node cluster wins immediately

    def _become_leader(self, now_ms: int = 0) -> None:
        self.state = LEADER
        self.leader_hint = self.id
        self.next_index = {p: len(self.log) for p in self.peers}
        self.match_index = {p: -1 for p in self.peers}
        self._peer_contact_ms = {p: now_ms for p in self.peers}
        self._last_heartbeat_ms = -(10**9)  # heartbeat immediately

    def _step_down(self, term: int) -> None:
        self.current_term = term
        self.state = FOLLOWER
        self.voted_for = None
        self._votes = set()
        self._timeout_ms = self._new_timeout()
        # Wake proposers parked on the commit condition: their entry can
        # no longer commit through this node (lost-leadership recheck).
        self.commit_cv.notify_all()

    # -------------------------------------------------------------- messages
    def receive(self, msg: Msg, now_ms: int) -> None:
        with self.lock:
            kind, b = msg.kind, msg.body
            self._peer_contact_ms[msg.src] = now_ms
            if b.get("term", 0) > self.current_term:
                self._step_down(b["term"])
            if kind == "request_vote":
                self._on_request_vote(msg, now_ms)
            elif kind == "vote_reply":
                self._on_vote_reply(msg, now_ms)
            elif kind == "append_entries":
                self._on_append_entries(msg, now_ms)
            elif kind == "append_reply":
                self._on_append_reply(msg, now_ms)

    def _on_request_vote(self, msg: Msg, now_ms: int) -> None:
        b = msg.body
        grant = False
        if b["term"] >= self.current_term:
            log_ok = b["last_log_term"] > self.last_log_term() or (
                b["last_log_term"] == self.last_log_term()
                and b["last_log_index"] >= self.last_log_index()
            )
            if log_ok and self.voted_for in (None, b["candidate"]):
                grant = True
                self.voted_for = b["candidate"]
                self._last_heard_ms = now_ms
        self._send(
            Msg(
                self.id,
                msg.src,
                "vote_reply",
                {"term": self.current_term, "granted": grant},
            )
        )

    def _on_vote_reply(self, msg: Msg, now_ms: int) -> None:
        b = msg.body
        if self.state != CANDIDATE or b["term"] != self.current_term:
            return
        if b["granted"]:
            self._votes.add(msg.src)
            self._maybe_win(now_ms)

    def _maybe_win(self, now_ms: int = 0) -> None:
        if self.state == CANDIDATE and len(self._votes) * 2 > len(self.peers) + 1:
            self._become_leader(now_ms)

    def _on_append_entries(self, msg: Msg, now_ms: int) -> None:
        b = msg.body
        if b["term"] < self.current_term:
            self._send(
                Msg(
                    self.id,
                    msg.src,
                    "append_reply",
                    {"term": self.current_term, "success": False, "match_index": -1},
                )
            )
            return
        # Valid leader for this term.
        self.state = FOLLOWER
        self.leader_hint = msg.src
        self._last_heard_ms = now_ms
        self._timeout_ms = self._new_timeout()
        prev_i, prev_t = b["prev_index"], b["prev_term"]
        ok = prev_i == -1 or (
            prev_i < len(self.log) and self.log[prev_i].term == prev_t
        )
        if not ok:
            self._send(
                Msg(
                    self.id,
                    msg.src,
                    "append_reply",
                    {"term": self.current_term, "success": False, "match_index": -1},
                )
            )
            return
        # Append / overwrite conflicting suffix (Raft log matching).
        idx = prev_i + 1
        for e in b["entries"]:
            entry = LogEntry(term=e["term"], entry=e["entry"])
            if idx < len(self.log):
                if self.log[idx].term != entry.term:
                    del self.log[idx:]
                    self.log.append(entry)
            else:
                self.log.append(entry)
            idx += 1
        if b["leader_commit"] > self.commit_index:
            self.commit_index = min(b["leader_commit"], len(self.log) - 1)
            self._apply_committed()
        self._send(
            Msg(
                self.id,
                msg.src,
                "append_reply",
                {
                    "term": self.current_term,
                    "success": True,
                    "match_index": prev_i + len(b["entries"]),
                },
            )
        )

    def _on_append_reply(self, msg: Msg, now_ms: int) -> None:
        b = msg.body
        if self.state != LEADER or b["term"] != self.current_term:
            return
        if b["success"]:
            self.match_index[msg.src] = max(
                self.match_index.get(msg.src, -1), b["match_index"]
            )
            self.next_index[msg.src] = self.match_index[msg.src] + 1
            self._advance_commit()
        else:
            self.next_index[msg.src] = max(0, self.next_index.get(msg.src, 0) - 1)

    def _advance_commit(self) -> None:
        # Majority-replicated entries from the current term become committed.
        for n in range(len(self.log) - 1, self.commit_index, -1):
            if self.log[n].term != self.current_term:
                continue
            count = 1 + sum(1 for p in self.peers if self.match_index.get(p, -1) >= n)
            if count * 2 > len(self.peers) + 1:
                self.commit_index = n
                self._apply_committed()
                break

    def _apply_committed(self) -> None:
        applied = False
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            self.apply_fn(self.log[self.last_applied].entry, self.last_applied)
            applied = True
        if applied:
            self.commit_cv.notify_all()

    def _broadcast_append(self, now_ms: int) -> None:
        self._last_heartbeat_ms = now_ms
        for p in self.peers:
            ni = self.next_index.get(p, len(self.log))
            prev_i = ni - 1
            prev_t = self.log[prev_i].term if prev_i >= 0 else 0
            entries = [e.to_dict() for e in self.log[ni : ni + 64]]
            self._send(
                Msg(
                    self.id,
                    p,
                    "append_entries",
                    {
                        "term": self.current_term,
                        "prev_index": prev_i,
                        "prev_term": prev_t,
                        "entries": entries,
                        "leader_commit": self.commit_index,
                    },
                )
            )

    # --------------------------------------------------------------- propose
    def propose(self, entry: dict) -> int | None:
        """Append an entry to the leader log; returns its index or None."""
        with self.lock:
            if self.state != LEADER:
                return None
            self.log.append(LogEntry(term=self.current_term, entry=entry))
            idx = len(self.log) - 1
            if not self.peers:  # single-node: commit immediately
                self.commit_index = idx
                self._apply_committed()
            else:
                self._broadcast_append(self._last_heartbeat_ms)
            return idx


# ---------------------------------------------------------------------------
# Simulated network + cluster drivers
# ---------------------------------------------------------------------------


class SimNetwork:
    """Deterministic message bus with drop probability and partitions."""

    def __init__(self, rng: random.Random | None = None) -> None:
        self.rng = rng or random.Random(0)
        self.queue: list[Msg] = []
        self.drop_prob = 0.0
        self.partitions: set[frozenset[str]] = set()  # unreachable pairs
        self.delivered = 0
        self.dropped = 0

    def send(self, msg: Msg) -> None:
        self.queue.append(msg)

    def partition(self, a: str, b: str) -> None:
        self.partitions.add(frozenset((a, b)))

    def heal(self) -> None:
        self.partitions.clear()

    def _blocked(self, msg: Msg) -> bool:
        return frozenset((msg.src, msg.dst)) in self.partitions

    def pump(self, nodes: dict[str, RaftNode], now_ms: int) -> int:
        """Deliver all queued messages (dropping per policy)."""
        n = 0
        msgs, self.queue = self.queue, []
        for m in msgs:
            if self._blocked(m) or self.rng.random() < self.drop_prob:
                self.dropped += 1
                continue
            node = nodes.get(m.dst)
            if node is not None:
                node.receive(m, now_ms)
                self.delivered += 1
                n += 1
        return n


class SimRaftCluster:
    """Virtual-clock cluster for deterministic tests."""

    def __init__(
        self,
        n: int,
        apply_fn: Callable[[str, dict, int], None] | None = None,
        seed: int = 0,
    ) -> None:
        self.rng = random.Random(seed)
        self.net = SimNetwork(random.Random(seed + 1))
        ids = [f"n{i}" for i in range(n)]
        self.nodes: dict[str, RaftNode] = {}
        for nid in ids:
            fn = (lambda nid_: lambda e, i: apply_fn and apply_fn(nid_, e, i))(nid)
            self.nodes[nid] = RaftNode(
                nid,
                ids,
                self.net.send,
                fn,
                rng=random.Random(seed * 100003 + _node_seed(nid)),
            )
        self.now_ms = 0

    def step(self, ms: int = 10) -> None:
        self.now_ms += ms
        for node in self.nodes.values():
            node.tick(self.now_ms)
        # Pump until quiescent this tick (bounded).
        for _ in range(8):
            if self.net.pump(self.nodes, self.now_ms) == 0:
                break

    def run_until_leader(self, max_ms: int = 10_000) -> str | None:
        start = self.now_ms
        while self.now_ms - start < max_ms:
            self.step()
            leaders = self.leaders()
            if leaders:
                return leaders[0]
        return None

    def leaders(self) -> list[str]:
        return [nid for nid, n in self.nodes.items() if n.is_leader()]

    def leaders_of_term(self) -> dict[int, list[str]]:
        out: dict[int, list[str]] = {}
        for nid, n in self.nodes.items():
            if n.is_leader():
                out.setdefault(n.current_term, []).append(nid)
        return out

    def kill(self, nid: str) -> None:
        for other in self.nodes:
            if other != nid:
                self.net.partition(nid, other)

    def revive(self, nid: str) -> None:
        self.net.partitions = {
            p for p in self.net.partitions if nid not in p
        }


class ThreadedRaftCluster:
    """Real-time driver: one event-loop thread ticks all nodes + delivers."""

    def __init__(
        self,
        n: int,
        apply_fn: Callable[[str, dict, int], Any] | None = None,
        seed: int = 0,
        tick_ms: int = 10,
    ) -> None:
        # Under REPRO_REPL_CHECK=1 every apply is journaled as
        # (index, chained digest) per node and cross-checked — the first
        # index at which replicas disagree records a
        # ReplicationDivergenceError (re-raised by propose_and_wait and
        # check_divergence). apply_fn may return an effect digest
        # (HAColonyCluster._apply does); it is folded into the chain.
        self.journal: statehash.ClusterJournal | None = None
        if statehash.is_enabled() and apply_fn is not None:
            self.journal = statehash.ClusterJournal()
            inner = apply_fn

            def journaled(nid: str, entry: dict, index: int) -> Any:
                effect = inner(nid, entry, index)
                self.journal.record(
                    nid, index, entry, effect if isinstance(effect, str) else None
                )
                return effect

            apply_fn = journaled
        self.sim = SimRaftCluster(n, apply_fn, seed)
        self.tick_ms = tick_ms
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = make_lock("cluster")

    @property
    def nodes(self) -> dict[str, RaftNode]:
        return self.sim.nodes

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.wait(self.tick_ms / 1000.0):
                try:
                    # Chaos hook: a raised fault skips this tick, a delay
                    # stalls the event loop (election churn under soak).
                    faults.hit("raft.tick")
                except faults.FaultInjected:
                    continue
                with self._lock:
                    self.sim.step(self.tick_ms)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    @no_locks_held("shard", "cfs", "glock", "dbcolony", "sqlite")
    def propose_and_wait(
        self, nid: str, entry: dict, timeout: float = COMMIT_TIMEOUT_S
    ) -> int:
        """Propose on node nid; block until that node has applied the entry.

        The waiter parks on the node's ``commit_cv`` — notified from
        ``_apply_committed`` after each batch of applies and from
        ``_step_down`` when leadership is lost — so commit latency is one
        notification away instead of a ``tick_ms/2`` polling round-trip.

        Contract: never entered holding a database lock — the commit is
        applied on the event-loop thread, which needs those same locks
        (the reference's first deadlock). The leader-local
        ``assignlocal`` lock is the one lock legitimately held across
        this wait.
        """
        node = self.nodes[nid]
        with self._lock:
            idx = node.propose(entry)
        if idx is None:
            raise NotLeaderError("propose on non-leader", leader=node.leader_hint)
        deadline = time.time() + timeout
        with node.commit_cv:
            while node.last_applied < idx:
                if node.state != LEADER:
                    raise NotLeaderError("lost leadership before commit")
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError_("raft commit timeout")
                # Bounded wait as a belt-and-braces recheck; the CV is
                # notified on both commit and step-down, so this timeout
                # almost never expires.
                node.commit_cv.wait(timeout=min(remaining, 0.25))
        self.check_divergence()
        return idx

    def check_divergence(self) -> None:
        """Raise the first recorded replica divergence (REPRO_REPL_CHECK)."""
        if self.journal is not None:
            self.journal.check()

    def leader_id(self) -> str | None:
        with self._lock:
            ls = self.sim.leaders()
        return ls[0] if ls else None

    def kill(self, nid: str) -> None:
        with self._lock:
            self.sim.kill(nid)

    def revive(self, nid: str) -> None:
        with self._lock:
            self.sim.revive(nid)
