"""Runtime replication-divergence contracts (the dynamic half of replint).

A copy of the reference's ``repro/analysis/statehash.py``, stdlib
only, with the same ``REPRO_REPL_CHECK`` switch.

The paper's HA deployment (§3.4.1, Fig. 3) serializes broker mutations
through a Raft log so replicas stay interchangeable across failover.
That only holds if every applied op is deterministic (same entry, same
resulting state on every node) and idempotent (replaying an entry is a
no-op). :mod:`repro_torch.analysis.replint` proves those properties
statically over the apply cone; this module checks them at runtime:

* :class:`ColonyDigest` — an **incremental per-colony digest** of broker
  state. Each process contributes one hash over its replication-visible
  tuple (state, owner, retries, queue membership, leader-stamped
  timestamps); the colony digest is the XOR-fold of the contributions,
  so updating one process after an apply is O(1), and the fold is
  order-independent (replicas need not observe processes in the same
  order).
* :class:`ClusterJournal` — per-node **apply journals**. On every Raft
  apply, the node appends ``(index, chained digest)`` where the chain
  folds in the entry's canonical digest and the apply's effect digest.
  The journal cross-checks nodes incrementally: the first index at which
  two nodes journal different digests raises (or records, on the event
  loop) :class:`ReplicationDivergenceError` — either their logs diverged
  (different entry at the same index) or an apply was nondeterministic.
* the **double-apply harness** lives in ``HAColonyCluster._apply``:
  under the flag, every applied entry is immediately applied a second
  time and the colony digest must be a fixpoint — a non-idempotent apply
  (one that survives its CAS twice) fails hard instead of silently
  double-mutating after a replay.

Everything is gated behind ``REPRO_REPL_CHECK=1`` (or :func:`enable`):
disabled, the hooks are a single flag check and no digests, journals, or
double applies happen.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

from .locktrack import make_lock


class ReplicationDivergenceError(AssertionError):
    """Two replicas applied the same Raft log prefix to different states,
    or an apply was not idempotent under replay."""


class _Registry:
    def __init__(self) -> None:
        self.enabled = os.environ.get("REPRO_REPL_CHECK", "") not in ("", "0")


_REG = _Registry()


def is_enabled() -> bool:
    return _REG.enabled


def enable(on: bool = True) -> None:
    """Toggle checking at runtime (tests)."""
    _REG.enabled = on


# ---------------------------------------------------------------------------
# Digests
# ---------------------------------------------------------------------------

_MASK = (1 << 256) - 1


def _h(data: str) -> int:
    return int.from_bytes(hashlib.sha256(data.encode("utf-8")).digest(), "big")


def process_state_tuple(p: Any) -> tuple:
    """The replication-visible row of one process.

    Exactly the fields a replicated apply may change, all of which must
    be derived from leader-stamped entry fields: state, ownership, queue
    membership, retry count, and the start/end stamps. Anything else
    (submission metadata, spec) is written outside the replicated plane.
    """
    return (
        p.processid,
        p.state,
        p.assignedexecutorid,
        int(p.retries),
        bool(p.wait_for_parents),
        bool(p.queue_ready),
        int(p.starttime_ns),
        int(p.endtime_ns),
    )


def item_digest(item: tuple) -> int:
    """Stable hash of one process's replication-visible tuple."""
    return _h(repr(item))


def entry_digest(entry: dict) -> str:
    """Canonical digest of a proposed/applied log entry (key-order free)."""
    return hashlib.sha256(
        json.dumps(entry, sort_keys=True, separators=(",", ":")).encode("utf-8")
    ).hexdigest()


class ColonyDigest:
    """Incremental XOR-fold digest over one colony's replicated rows.

    ``observe(pid, item)`` replaces ``pid``'s contribution in O(1); the
    fold is order-independent, so every replica converges on the same
    digest regardless of the order it observed processes in. Only
    processes touched by replicated applies are tracked — submissions
    happen outside the Raft log in the shared-database deployment.
    """

    __slots__ = ("_items", "_acc")

    def __init__(self) -> None:
        self._items: dict[str, int] = {}
        self._acc = 0

    def observe(self, pid: str, item: tuple) -> None:
        h = item_digest(item)
        old = self._items.get(pid)
        if old is not None:
            self._acc ^= old
        self._items[pid] = h
        self._acc = (self._acc ^ h) & _MASK

    def forget(self, pid: str) -> None:
        old = self._items.pop(pid, None)
        if old is not None:
            self._acc ^= old

    def digest(self) -> str:
        return f"{self._acc:064x}"

    def __len__(self) -> int:
        return len(self._items)


def full_colony_digest(db: Any, colony: str) -> str:
    """Non-incremental digest over ``db.replica_state(colony)``.

    The from-scratch recomputation tests compare against the incremental
    fold (they must agree whenever every process has been observed).
    """
    d = ColonyDigest()
    for item in db.replica_state(colony):
        d.observe(item[0], item)
    return d.digest()


# ---------------------------------------------------------------------------
# Apply journals
# ---------------------------------------------------------------------------


class ClusterJournal:
    """Per-node apply journals with incremental cross-checking.

    Each node's journal is a list of ``(index, digest)`` where the digest
    chains the previous journal digest, the entry's canonical digest, and
    the apply's effect digest (the post-apply colony digest, shared by
    the HA cluster across its deduped replicas). Chaining makes a single
    divergent apply poison every later index, so the *first* divergent
    index is always detected even if later digests collide.

    ``record`` never raises on the Raft event-loop thread — the first
    divergence is stored and re-raised by :meth:`check` (and by
    ``ThreadedRaftCluster.propose_and_wait``), so the loop keeps driving
    the cluster while tests and callers fail loudly.
    """

    def __init__(self) -> None:
        self._lock = make_lock("repljournal")
        self._journals: dict[str, list[tuple[int, str]]] = {}
        self._chains: dict[str, str] = {}
        # First digest journaled per index, and by whom (the cross-check).
        self._by_index: dict[int, tuple[str, str]] = {}
        self.divergence: ReplicationDivergenceError | None = None

    def record(
        self, node_id: str, index: int, entry: dict, effect: str | None
    ) -> None:
        ed = entry_digest(entry)
        with self._lock:
            prev = self._chains.get(node_id, "")
            digest = hashlib.sha256(
                f"{prev}|{index}|{ed}|{effect or ''}".encode("utf-8")
            ).hexdigest()
            self._chains[node_id] = digest
            self._journals.setdefault(node_id, []).append((index, digest))
            first = self._by_index.get(index)
            if first is None:
                self._by_index[index] = (digest, node_id)
            elif first[0] != digest and self.divergence is None:
                self.divergence = ReplicationDivergenceError(
                    f"replica state diverged at raft index {index}:"
                    f" node {node_id} journaled {digest[:16]}… but node"
                    f" {first[1]} journaled {first[0][:16]}… (nondeterministic"
                    " or non-idempotent apply — see TORCH_CONTRACTS.md)"
                )

    def entries(self, node_id: str) -> list[tuple[int, str]]:
        with self._lock:
            return list(self._journals.get(node_id, ()))

    def nodes(self) -> list[str]:
        with self._lock:
            return sorted(self._journals)

    def note(self, exc: ReplicationDivergenceError) -> None:
        """Record an externally detected divergence (double-apply harness).

        Like :meth:`record`, never raises — the apply runs on the Raft
        event-loop thread; the error surfaces via :meth:`check`.
        """
        with self._lock:
            if self.divergence is None:
                self.divergence = exc

    def check(self) -> None:
        """Re-raise the first recorded divergence, if any."""
        if self.divergence is not None:
            raise self.divergence
