"""High-availability deployment (paper §3.4.1, Fig. 3).

N Colonies server replicas share one database (the paper's shared
Postgres); a Raft cluster elects the leader. Only the leader serves
``assign`` — followers answer 421 and the SDK transport retries against
the next replica. Assign operations are serialized through the Raft log
before being applied, guaranteeing exactly one executor per process even
across leader failovers; the apply is idempotent so replay is safe.

Cron/generator scanning and the failsafe run on the leader only.

A copy of the reference's ``repro/core/cluster.py``, stdlib only, over
the port's broker: one shared database (``db``, a ``MemoryDatabase`` by
default, or a ``SqliteDatabase``) and one ``ColoniesServer`` per replica.
Every replica verifies every signature (the port's broker has no
unverified path).
"""

from __future__ import annotations

import time
from collections import deque

from ..analysis import statehash
from ..analysis.locktrack import make_lock
from ..core.errors import ConflictError, NotFoundError
from .cfs import CFSExtension
from .cron import CronExtension
from .database import Database, MemoryDatabase
from .generator import GeneratorExtension
from .raft import ThreadedRaftCluster
from .server import ColoniesServer

# The replicated-op matrix (the reference's REPLICATION.md is generated
# from its copy of this literal). Every op MUST carry the leader-stamped fields — wall-clock and
# identity are fixed before the Raft log so the apply is deterministic —
# and every apply MUST be CAS-guarded under the colony lock so replaying
# the entry after a failover is a no-op.
REPLICATED_OPS: dict[str, dict] = {
    "assign": {
        "apply": "ColoniesServer.apply_assign",
        "required": ("op", "opid", "processid", "executorid", "ts", "msgid"),
        "leader_stamped": ("opid", "ts", "msgid"),
        "cas": "state == WAITING under db.colony_lock",
    },
    "close": {
        "apply": "ColoniesServer.apply_close",
        "required": (
            "op",
            "opid",
            "processid",
            "executorid",
            "successful",
            "out",
            "errors",
            "ts",
            "msgid",
        ),
        "leader_stamped": ("opid", "ts", "msgid"),
        "cas": "state == RUNNING and executor ownership under db.colony_lock",
    },
}


class HAColonyCluster:
    """A replicated Colonies service: ``cluster.servers`` are the replicas."""

    def __init__(
        self,
        serverid: str,
        replicas: int = 3,
        db: Database | None = None,
        seed: int = 0,
    ) -> None:
        # One shared database: its per-colony locks (db.colony_lock) are the
        # serialization point for assign/close/failsafe across ALL replicas.
        self.db = db if db is not None else MemoryDatabase()
        self.servers: list[ColoniesServer] = []
        self._applied_lock = make_lock("applied")
        # Bounded replay-dedup window; the per-op CAS (see REPLICATED_OPS)
        # is the authoritative idempotence guard for anything older.
        self._applied_ops: set[str] = set()
        self._applied_order: deque[str] = deque(maxlen=4096)
        # REPRO_REPL_CHECK state: one incremental digest per colony, and
        # the effect digest journaled by the first node to apply each
        # index. All applies run on the single Raft event-loop thread, but
        # a lagging node may apply index i after the leader already
        # applied i+1 — digesting the live shared DB again would falsely
        # diverge, so replays reuse the first applier's effect.
        self._digests: dict[str, statehash.ColonyDigest] = {}
        self._effect_by_index: dict[int, str] = {}
        self._effect_order: deque[int] = deque(maxlen=65536)

        self.raft = ThreadedRaftCluster(replicas, self._apply, seed=seed)

        for i in range(replicas):
            srv = ColoniesServer(serverid, self.db, name=f"colonies-{i}")
            CronExtension(srv)
            GeneratorExtension(srv)
            CFSExtension(srv)
            nid = f"n{i}"
            node = self.raft.nodes[nid]
            srv.set_leader_check(node.is_leader)
            srv.set_op_proposer(
                (lambda nid_: lambda op: self._propose(nid_, op))(nid)
            )
            self.servers.append(srv)

    def _propose(self, nid: str, op: dict) -> int:
        spec = REPLICATED_OPS.get(op.get("op", ""))
        if spec is None:
            raise ValueError(f"not a replicated op: {op.get('op')!r}")
        missing = [f for f in spec["required"] if f not in op]
        if missing:
            # Leader-side contract: an entry missing its stamped fields
            # would force the apply to improvise them per replica.
            raise ValueError(
                f"replicated {op['op']} entry missing fields: {missing}"
            )
        return self.raft.propose_and_wait(nid, op)

    # Replicated state machine apply — idempotent against the shared DB.
    # Returns the effect digest under REPRO_REPL_CHECK (folded into the
    # per-node apply journal by ThreadedRaftCluster), else None.
    def _apply(self, node_id: str, entry: dict, index: int) -> str | None:
        spec = REPLICATED_OPS.get(entry.get("op", ""))
        if spec is None:
            return None
        apply_op = getattr(self.servers[0], spec["apply"].split(".", 1)[1])
        key = entry.get("opid") or (
            f"{entry['processid']}:{entry['executorid']}:{entry['ts']}"
        )
        with self._applied_lock:
            if key in self._applied_ops:
                # Replay of an index another node already applied: the
                # shared DB may have moved on, so report the effect the
                # first applier journaled for this index.
                return self._effect_by_index.get(index)
            if len(self._applied_order) == self._applied_order.maxlen:
                self._applied_ops.discard(self._applied_order[0])
            self._applied_order.append(key)
            self._applied_ops.add(key)
        if not statehash.is_enabled():
            try:
                apply_op(entry)
            except ConflictError:
                # Same op replayed after a failover — already applied.
                pass
            return None
        return self._apply_checked(apply_op, entry, index)

    def _apply_checked(self, apply_op, entry: dict, index: int) -> str | None:
        """First apply of ``entry`` under REPRO_REPL_CHECK.

        Applies, folds the touched rows into the colony digest, then runs
        the double-apply harness: re-applies the same entry and requires
        the digest to be a fixpoint, proving the CAS makes replay a no-op.
        Holding the (reentrant) colony lock across observe → re-apply →
        re-observe keeps the leader's failsafe thread from mutating the
        colony mid-harness. Never raises on the event-loop thread —
        divergence is noted in the journal and re-raised by
        ``propose_and_wait`` / ``check_divergence``.
        """
        try:
            colony = self.db.get_process(entry["processid"]).colonyname
        except NotFoundError:
            return None
        digest = self._digests.get(colony)
        if digest is None:
            digest = self._digests[colony] = statehash.ColonyDigest()
        with self.db.colony_lock(colony):
            try:
                apply_op(entry)
            except ConflictError:
                pass
            self._observe(digest, entry)
            effect = digest.digest()
            try:
                apply_op(entry)
            except ConflictError:
                pass
            self._observe(digest, entry)
            if digest.digest() != effect and self.raft.journal is not None:
                self.raft.journal.note(
                    statehash.ReplicationDivergenceError(
                        f"apply of {entry.get('op')} entry"
                        f" {entry.get('opid', '?')[:16]} at raft index"
                        f" {index} is not idempotent: double-apply moved"
                        f" the colony digest {effect[:16]}… →"
                        f" {digest.digest()[:16]}…"
                    )
                )
        with self._applied_lock:
            if len(self._effect_order) == self._effect_order.maxlen:
                self._effect_by_index.pop(self._effect_order[0], None)
            self._effect_order.append(index)
            self._effect_by_index[index] = effect
        return effect

    def _observe(self, digest: statehash.ColonyDigest, entry: dict) -> None:
        """Fold the rows a replicated apply may touch into the digest:
        the primary process and (close cascades) its direct children."""
        pids = [entry["processid"]]
        if entry.get("op") == "close":
            try:
                pids.extend(self.db.get_process(entry["processid"]).children)
            except NotFoundError:
                pass
        for pid in pids:
            try:
                p = self.db.get_process(pid)
            except NotFoundError:
                digest.forget(pid)
                continue
            digest.observe(pid, statehash.process_state_tuple(p))

    def start(self, failsafe_interval: float = 0.25) -> None:
        self.raft.start()
        for srv in self.servers:
            srv.start_background(failsafe_interval)

    def stop(self) -> None:
        for srv in self.servers:
            srv.stop()
        self.raft.stop()

    def leader_server(self) -> ColoniesServer | None:
        lid = self.raft.leader_id()
        if lid is None:
            return None
        return self.servers[int(lid[1:])]

    def kill_server(self, index: int) -> None:
        """Chaos: partition a replica away (its raft node stops hearing)."""
        self.raft.kill(f"n{index}")

    def revive_server(self, index: int) -> None:
        self.raft.revive(f"n{index}")

    def wait_for_leader(self, timeout: float = 10.0) -> str | None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            lid = self.raft.leader_id()
            if lid is not None:
                return lid
            time.sleep(0.02)
        return None

