"""Queue-as-database (paper §3.2–3.3), copied from the reference's
``repro/core/database.py``: the broker's indexed, file-backed or
in-memory core.

The paper's key departure from broker-based workflow systems: the queue
IS a standard database table, so assignment can match *any* column
(fine-grained per-executor targeting, capability matching, introspection)
and ordering is a plain ``ORDER BY priority_time``.

Two backends behind one interface:

* :class:`SqliteDatabase` — faithful to the paper (Postgres in the Go
  implementation): the candidate query is literally an ``ORDER BY
  priority_time ASC`` SQL select over covering indexes; file-backed
  (survives restarts) or ``:memory:``. Its schema is the reference's
  byte for byte, so a file written by either package opens in the other.
* :class:`MemoryDatabase` — per-colony sharded in-process tables;
  identical semantics.

Both backends maintain the same auxiliary indexes so the server's hot
paths do bounded work regardless of how many processes have ever been
stored:

* **per-colony state counters** — ``colony_stats`` is an O(states) dict
  read (memdb) or a 4-row indexed select (sqlite), never a table scan;
* **deadline indexes** — ``running_past_deadline`` /
  ``waiting_past_deadline`` pop lazily-invalidated min-heaps (memdb) or
  range-scan ``(state, deadline)`` B-tree indexes (sqlite), so the
  failsafe tick touches only expired + stale entries;
* **ready-queue side-listing** — ``wait_for_parents`` processes are kept
  out of the ready queues entirely (they re-enter via ``requeue`` when
  released) and executor-targeted processes live in per-target side
  queues, so neither class can pin the queue head for everyone else;
* **per-colony locks** — ``colony_lock(colony)`` hands out one lock per
  colony, shared by every server replica using the same database object,
  so assignment/close/failsafe serialize per colony instead of across
  the whole deployment.

Stale ready-queue entries (processes assigned, closed, or expired since
they were enqueued) are dropped lazily: each candidate scan compacts the
prefix it walked in a single pass, and a whole queue is rebuilt once its
stale count dominates — never one ``list.remove`` per entry.

What differs from the reference: ``Colony`` and ``Executor`` live here
(the port's ``core.process`` holds only what an executor reads). As in
the reference, every lock comes from ``analysis.locktrack.make_lock``
under the families ``shard:``, ``cfs:``, ``glock``, ``sqlite`` and
``dbcolony:``, the shard and sqlite helpers declare their lock with
``@requires_lock``, and the colony-scoped entry points are guarded by
``analysis.authtrack`` (``Database.__init_subclass__``). The memory backend hands out the stored
``Process`` objects themselves, the sqlite backend fresh copies: callers
re-read a process under its colony lock before they check or mutate it.
Stdlib only.
"""

from __future__ import annotations

import bisect
import heapq
import json
import marshal
import sqlite3
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable

from ..core.errors import ConflictError, NotFoundError
from ..core.process import RUNNING, WAITING, Process, now_ns
from ..analysis.authtrack import guard_database_subclass
from ..analysis.contracts import requires_lock
from ..analysis.locktrack import make_lock
from ..analysis.statehash import process_state_tuple
from ..runtime import faults


@dataclass
class Executor:
    """A registered colony member (paper Table 5)."""

    executorid: str = ""
    executorname: str = ""
    executortype: str = ""
    colonyname: str = ""
    state: str = "pending"  # pending -> approved | rejected
    commissiontime_ns: int = field(default_factory=now_ns)
    lastheardfrom_ns: int = 0
    capabilities: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "executorid": self.executorid,
            "executorname": self.executorname,
            "executortype": self.executortype,
            "colonyname": self.colonyname,
            "state": self.state,
            "commissiontime": self.commissiontime_ns,
            "lastheardfrom": self.lastheardfrom_ns,
            "capabilities": dict(self.capabilities),
        }

    @staticmethod
    def from_dict(d: dict) -> "Executor":
        return Executor(
            executorid=d.get("executorid", ""),
            executorname=d.get("executorname", ""),
            executortype=d.get("executortype", ""),
            colonyname=d.get("colonyname", d.get("colonyid", "")),
            state=d.get("state", "pending"),
            commissiontime_ns=int(d.get("commissiontime", 0)),
            lastheardfrom_ns=int(d.get("lastheardfrom", 0)),
            capabilities=dict(d.get("capabilities", {}) or {}),
        )


@dataclass
class Colony:
    colonyname: str = ""
    colonyid: str = ""  # identity (SHA3 of colony owner pubkey)

    def to_dict(self) -> dict:
        return {"colonyname": self.colonyname, "colonyid": self.colonyid}

    @staticmethod
    def from_dict(d: dict) -> "Colony":
        return Colony(colonyname=d.get("colonyname", ""), colonyid=d.get("colonyid", ""))


# RPC dedup table bounds (ROBUSTNESS.md): a record only needs to outlive
# its client's retry window, so entries expire after DEDUP_TTL_NS and each
# colony keeps at most DEDUP_MAX_PER_COLONY records (oldest evicted first).
DEDUP_TTL_NS = 600 * 10**9
DEDUP_MAX_PER_COLONY = 4096


class Database:
    """Abstract storage interface shared by all Colonies server replicas."""

    def __init_subclass__(cls, **kwargs) -> None:
        super().__init_subclass__(**kwargs)
        # Under REPRO_AUTH_CHECK=1, colony-scoped entry points refuse to
        # run inside a request that never recorded an auth fact for the
        # colony they touch (see analysis/authtrack.py).
        guard_database_subclass(cls)

    # -- colonies ---------------------------------------------------------
    def add_colony(self, colony: Colony) -> None:
        raise NotImplementedError

    def get_colony(self, name: str) -> Colony:
        raise NotImplementedError

    def list_colonies(self) -> list[Colony]:
        raise NotImplementedError

    # -- executors --------------------------------------------------------
    def add_executor(self, ex: Executor) -> None:
        raise NotImplementedError

    def get_executor(self, executorid: str) -> Executor:
        raise NotImplementedError

    def get_executor_by_name(self, colony: str, name: str) -> Executor:
        raise NotImplementedError

    def list_executors(self, colony: str) -> list[Executor]:
        raise NotImplementedError

    def set_executor_state(self, executorid: str, state: str) -> None:
        raise NotImplementedError

    def remove_executor(self, executorid: str) -> None:
        raise NotImplementedError

    def touch_executor(self, executorid: str, ts: int) -> None:
        raise NotImplementedError

    # -- function registry --------------------------------------------------
    def add_function(self, executorid: str, colony: str, funcname: str) -> None:
        raise NotImplementedError

    def list_functions(self, colony: str, executorid: str | None = None) -> list[dict]:
        raise NotImplementedError

    # -- processes ----------------------------------------------------------
    def add_process(self, p: Process) -> None:
        raise NotImplementedError

    def get_process(self, processid: str) -> Process:
        raise NotImplementedError

    def update_process(self, p: Process) -> None:
        raise NotImplementedError

    def candidates(
        self, colony: str, executortype: str, executorname: str, limit: int = 8
    ) -> list[Process]:
        """Waiting, parent-free processes for this executor, oldest priority first."""
        raise NotImplementedError

    def list_processes(
        self, colony: str, state: str | None = None, count: int = 100
    ) -> list[Process]:
        raise NotImplementedError

    def running_past_deadline(self, ts: int) -> list[Process]:
        raise NotImplementedError

    def waiting_past_deadline(self, ts: int) -> list[Process]:
        raise NotImplementedError

    def delete_process(self, processid: str) -> None:
        raise NotImplementedError

    def colony_stats(self, colony: str) -> dict[str, int]:
        """Per-state process counts for one colony; O(states), not O(processes)."""
        raise NotImplementedError

    def colony_lock(self, colony: str) -> threading.RLock:
        """Per-colony critical-section lock, shared by all replicas on this db."""
        raise NotImplementedError

    def requeue(self, p: Process) -> None:
        """Re-insert a reset or released process into the ready queues."""
        raise NotImplementedError

    # -- RPC dedup table (exactly-once mutating RPCs; ROBUSTNESS.md) --------
    # Keyed on "identity:msgid". Bounded: TTL-evicted plus a per-colony
    # record cap, so a retry storm cannot grow the table without limit.
    # Lives in the shared db so every HA replica dedups identically.
    def dedup_get(self, key: str) -> dict | None:
        """Recorded reply for a keyed RPC, or None if never completed."""
        raise NotImplementedError

    def dedup_put(self, key: str, colony: str, ts: int, reply) -> None:
        """Record the reply of a completed keyed RPC (successes only)."""
        raise NotImplementedError

    def replica_state(self, colony: str) -> list[tuple]:
        """Replication-visible rows of one colony, for digest cross-checks.

        One tuple per process, matching
        :func:`repro_torch.analysis.statehash.process_state_tuple`: (processid,
        state, assignedexecutorid, retries, wait_for_parents, queue_ready,
        starttime_ns, endtime_ns). Order is unspecified — the digest fold
        is order-independent.
        """
        raise NotImplementedError

    # -- CFS metadata plane (fs.py; paper §3.4.5) ---------------------------
    # Indexed per colony so no operation ever scans the whole file table:
    # label trees answer subtree listings, (label, name) revision heads
    # answer lookups/next-revision, and pin refcounts answer removal checks.
    def cfs_add_file(self, entry: dict) -> dict:
        """Store a new revision; assigns ``entry['revision']`` = head + 1."""
        raise NotImplementedError

    def cfs_get_file(self, colony: str, fileid: str) -> dict | None:
        raise NotImplementedError

    def cfs_get_files_by_ids(self, colony: str, fileids: list[str]) -> list[dict | None]:
        """Batched lookup, one entry per id in order (None where absent)."""
        raise NotImplementedError

    def cfs_head(self, colony: str, label: str, name: str) -> dict | None:
        """Latest revision of (label, name), or None."""
        raise NotImplementedError

    def cfs_list(self, colony: str, label: str) -> list[dict]:
        """Latest revisions at ``label`` and below, sorted by (label, name)."""
        raise NotImplementedError

    def cfs_remove_file(self, colony: str, fileid: str) -> dict | None:
        """Remove one revision; ConflictError if pinned, None if absent."""
        raise NotImplementedError

    def cfs_pin_count(self, colony: str, fileid: str) -> int:
        """How many live snapshots pin this revision (O(1)/indexed)."""
        raise NotImplementedError

    def cfs_create_snapshot(self, snap: dict) -> dict:
        """Atomically pin the heads under ``snap['label']``; fills 'fileids'."""
        raise NotImplementedError

    def cfs_get_snapshot(self, colony: str, snapshotid: str) -> dict | None:
        raise NotImplementedError

    def cfs_list_snapshots(self, colony: str) -> list[dict]:
        """All snapshots of one colony, oldest first (indexed per colony)."""
        raise NotImplementedError

    def cfs_remove_snapshot(self, colony: str, snapshotid: str) -> dict | None:
        """Remove a snapshot and release its pins; None if absent."""
        raise NotImplementedError

    # -- cron / generator tables (cron.py, generator.py) --------------------
    # First-class per-colony indexed tables: listings never scan other
    # colonies' entries, and the cron leader tick reads a deadline index
    # instead of the whole table (the kv buckets the seed used survive
    # only as a sqlite migration source).
    def cron_put(self, entry: dict) -> None:
        """Insert or update a cron entry (keyed by ``entry['cronid']``)."""
        raise NotImplementedError

    def cron_get(self, cronid: str) -> dict | None:
        raise NotImplementedError

    def cron_del(self, cronid: str) -> None:
        raise NotImplementedError

    def cron_list(self, colony: str) -> list[dict]:
        raise NotImplementedError

    def cron_due(self, ts: int) -> list[dict]:
        """Entries with ``deadline < ts`` via the deadline index, O(due)."""
        raise NotImplementedError

    def generator_put(self, entry: dict) -> None:
        raise NotImplementedError

    def generator_get(self, generatorid: str) -> dict | None:
        raise NotImplementedError

    def generator_del(self, generatorid: str) -> None:
        raise NotImplementedError

    def generator_list(self, colony: str) -> list[dict]:
        raise NotImplementedError

    def generator_all(self) -> list[dict]:
        """Every generator (leader tick); first-class table iteration."""
        raise NotImplementedError

    # -- colony users (server.py `_require_member`; paper Table 5) ----------
    # First-class table keyed by userid with a per-colony listing index,
    # so membership checks stay O(1) and `listusers` never scans other
    # colonies (the kv bucket the seed used survives as a migration source).
    def user_put(self, entry: dict) -> None:
        """Insert or update a user (keyed by ``entry['userid']``)."""
        raise NotImplementedError

    def user_get(self, userid: str) -> dict | None:
        raise NotImplementedError

    def user_del(self, userid: str) -> None:
        raise NotImplementedError

    def user_list(self, colony: str) -> list[dict]:
        """All users of one colony, sorted by name (indexed per colony)."""
        raise NotImplementedError

    # -- key/value side tables (cron, generators, CFS metadata) -------------
    def kv_put(self, table: str, key: str, value: dict) -> None:
        raise NotImplementedError

    def kv_get(self, table: str, key: str) -> dict | None:
        raise NotImplementedError

    def kv_del(self, table: str, key: str) -> None:
        raise NotImplementedError

    def kv_list(self, table: str) -> list[dict]:
        raise NotImplementedError

    def kv_append(self, table: str, key: str, value: dict) -> int:
        """Append to a list bucket; returns new length (generator pack queues)."""
        raise NotImplementedError

    def kv_take_all(self, table: str, key: str) -> list[dict]:
        """Atomically drain a list bucket."""
        raise NotImplementedError

    def kv_len(self, table: str, key: str) -> int:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# In-memory backend
# ---------------------------------------------------------------------------

# Compact a ready queue outright once this many stale entries accumulated
# AND they outnumber the live ones (amortized O(1) per transition).
_COMPACT_MIN_STALE = 64


class _ColonyShard:
    """All mutable broker state for one colony, guarded by one lock."""

    __slots__ = (
        "lock",
        "procs",
        "queues",
        "targeted",
        "stale",
        "counters",
        "acct",
        "exec_heap",
        "wait_heap",
        "exec_pushed",
        "wait_pushed",
    )

    def __init__(self, colony: str = "") -> None:
        self.lock = make_lock(f"shard:{colony}")
        self.procs: dict[str, Process] = {}
        # executortype -> sorted [(priority_time, pid)] of ready untargeted procs
        self.queues: dict[str, list[tuple[int, str]]] = {}
        # executortype -> executorname -> sorted [(priority_time, pid)]
        self.targeted: dict[str, dict[str, list[tuple[int, str]]]] = {}
        self.stale: dict[str, int] = {}  # executortype -> stale-entry estimate
        self.counters: dict[str, int] = {}  # state -> live count
        self.acct: dict[str, str] = {}  # pid -> last counted state
        self.exec_heap: list[tuple[int, str]] = []  # (deadline, pid), RUNNING
        self.wait_heap: list[tuple[int, str]] = []  # (waitdeadline, pid), WAITING
        self.exec_pushed: dict[str, int] = {}  # pid -> deadline currently in heap
        self.wait_pushed: dict[str, int] = {}


class _CfsShard:
    """One colony's CFS metadata, guarded by one lock.

    ``by_label`` is the revision index: label -> name -> ascending
    ``(revision, fileid)`` list whose tail is the head revision.
    ``children`` is the label tree: label -> immediate child labels, so a
    subtree listing walks exactly the labels under the query prefix.
    ``pins`` maps fileid -> the set of snapshot ids pinning it (refcount =
    set size), making the removal check O(1) instead of a snapshot scan.
    """

    __slots__ = ("lock", "files", "by_label", "children", "snapshots", "pins")

    def __init__(self, colony: str = "") -> None:
        self.lock = make_lock(f"cfs:{colony}")
        self.files: dict[str, dict] = {}
        self.by_label: dict[str, dict[str, list[tuple[int, str]]]] = {}
        self.children: dict[str, set[str]] = {}
        self.snapshots: dict[str, dict] = {}
        self.pins: dict[str, set[str]] = {}


def _cfs_parent(label: str) -> str:
    return label.rsplit("/", 1)[0] or "/"


class MemoryDatabase(Database):
    def __init__(self) -> None:
        # Registries + shard map only; a LEAF lock (see CONCURRENCY.md):
        # nothing may be acquired and nothing may block while holding it.
        self._glock = make_lock("glock")
        self._colonies: dict[str, Colony] = {}
        self._executors: dict[str, Executor] = {}
        self._functions: list[dict] = []
        self._shards: dict[str, _ColonyShard] = {}
        self._cfs_shards: dict[str, _CfsShard] = {}
        self._pid_colony: dict[str, str] = {}
        self._kv: dict[str, dict[str, dict]] = {}
        self._kvlists: dict[str, dict[str, list[dict]]] = {}
        # Cron/generator tables: colony -> id -> entry, with reverse maps
        # for id-keyed lookups and a lazily-invalidated cron deadline heap.
        self._crons: dict[str, dict[str, dict]] = {}
        self._cron_colony: dict[str, str] = {}
        self._cron_heap: list[tuple[int, str]] = []
        self._generators: dict[str, dict[str, dict]] = {}
        self._generator_colony: dict[str, str] = {}
        # Colony users: colony -> userid -> entry, with a reverse map for
        # the id-keyed membership check (`_require_member`).
        self._users: dict[str, dict[str, dict]] = {}
        self._user_colony: dict[str, str] = {}
        # RPC dedup records: key -> (ts, colony, marshal-blob), plus a
        # per-colony FIFO of keys driving cap/TTL eviction. Both live
        # under _glock (straight-line dict/deque ops only — leaf lock).
        self._dedup: dict[str, tuple[int, str, bytes]] = {}
        self._dedup_fifo: dict[str, deque[str]] = {}
        # Observability for bounded-work regression tests/benchmarks.
        self.metrics: dict[str, int] = {
            "deadline_pops": 0,
            "queue_scan_steps": 0,
            "stale_evicted": 0,
            "compactions": 0,
            "cfs_nodes_visited": 0,
        }

    def _shard(self, colony: str) -> _ColonyShard:
        with self._glock:
            s = self._shards.get(colony)
            if s is None:
                s = self._shards[colony] = _ColonyShard(colony)
            return s

    def _cfs(self, colony: str) -> _CfsShard:
        with self._glock:
            s = self._cfs_shards.get(colony)
            if s is None:
                s = self._cfs_shards[colony] = _CfsShard(colony)
            return s

    def colony_lock(self, colony: str) -> threading.RLock:
        return self._shard(colony).lock

    # colonies
    def add_colony(self, colony: Colony) -> None:
        with self._glock:
            if colony.colonyname in self._colonies:
                raise ConflictError(f"colony {colony.colonyname} exists")
            self._colonies[colony.colonyname] = colony

    def get_colony(self, name: str) -> Colony:
        with self._glock:
            c = self._colonies.get(name)
            if c is None:
                raise NotFoundError(f"colony {name} not found")
            return c

    def list_colonies(self) -> list[Colony]:
        with self._glock:
            return list(self._colonies.values())

    # executors
    def add_executor(self, ex: Executor) -> None:
        with self._glock:
            if ex.executorid in self._executors:
                raise ConflictError("executor exists")
            for other in self._executors.values():
                if (
                    other.colonyname == ex.colonyname
                    and other.executorname == ex.executorname
                ):
                    raise ConflictError(f"executor name {ex.executorname} taken")
            self._executors[ex.executorid] = ex

    def get_executor(self, executorid: str) -> Executor:
        with self._glock:
            ex = self._executors.get(executorid)
            if ex is None:
                raise NotFoundError("executor not found")
            return ex

    def get_executor_by_name(self, colony: str, name: str) -> Executor:
        with self._glock:
            for ex in self._executors.values():
                if ex.colonyname == colony and ex.executorname == name:
                    return ex
            raise NotFoundError(f"executor {name} not found")

    def list_executors(self, colony: str) -> list[Executor]:
        with self._glock:
            return [e for e in self._executors.values() if e.colonyname == colony]

    def set_executor_state(self, executorid: str, state: str) -> None:
        with self._glock:
            self.get_executor(executorid).state = state

    def remove_executor(self, executorid: str) -> None:
        with self._glock:
            if executorid not in self._executors:
                raise NotFoundError("executor not found")
            del self._executors[executorid]

    def touch_executor(self, executorid: str, ts: int) -> None:
        with self._glock:
            ex = self._executors.get(executorid)
            if ex is not None:
                ex.lastheardfrom_ns = ts

    # functions
    def add_function(self, executorid: str, colony: str, funcname: str) -> None:
        with self._glock:
            self._functions.append(
                {"executorid": executorid, "colonyname": colony, "funcname": funcname}
            )

    def list_functions(self, colony: str, executorid: str | None = None) -> list[dict]:
        with self._glock:
            return [
                dict(f)
                for f in self._functions
                if f["colonyname"] == colony
                and (executorid is None or f["executorid"] == executorid)
            ]

    # -- process bookkeeping (contract: shard lock held) ------------------------
    @requires_lock("shard")
    def _account(self, s: _ColonyShard, p: Process) -> None:
        old = s.acct.get(p.processid)
        if old == p.state:
            return
        if old is not None:
            s.counters[old] = s.counters.get(old, 0) - 1
            if old == WAITING:
                self._note_stale(s, p)
        s.counters[p.state] = s.counters.get(p.state, 0) + 1
        s.acct[p.processid] = p.state

    @requires_lock("shard")
    def _note_stale(self, s: _ColonyShard, p: Process) -> None:
        etype = p.spec.conditions.executortype
        # One unit per queue entry the process held: a multi-target process
        # left one entry in each target's side queue.
        entries = len(p.spec.conditions.executornames) or 1
        s.stale[etype] = s.stale.get(etype, 0) + entries
        self._maybe_compact(s, etype)

    @requires_lock("shard")
    def _maybe_compact(self, s: _ColonyShard, etype: str) -> None:
        n_stale = s.stale.get(etype, 0)
        q = s.queues.get(etype, [])
        tmap = s.targeted.get(etype, {})
        total = len(q) + sum(len(v) for v in tmap.values())
        if n_stale < _COMPACT_MIN_STALE or n_stale * 2 <= total:
            return

        def live(entry: tuple[int, str]) -> bool:
            lp = s.procs.get(entry[1])
            return lp is not None and lp.queue_ready

        before = total
        q[:] = [e for e in q if live(e)]
        for name in list(tmap):
            tq = tmap[name]
            tq[:] = [e for e in tq if live(e)]
            if not tq:
                del tmap[name]
        after = len(q) + sum(len(v) for v in tmap.values())
        s.stale[etype] = 0
        self.metrics["compactions"] += 1
        self.metrics["stale_evicted"] += before - after

    @requires_lock("shard")
    def _push_deadlines(self, s: _ColonyShard, p: Process) -> None:
        pid = p.processid
        if p.state == RUNNING and p.deadline_ns:
            if s.exec_pushed.get(pid) != p.deadline_ns:
                heapq.heappush(s.exec_heap, (p.deadline_ns, pid))
                s.exec_pushed[pid] = p.deadline_ns
        if p.state == WAITING and p.waitdeadline_ns:
            if s.wait_pushed.get(pid) != p.waitdeadline_ns:
                heapq.heappush(s.wait_heap, (p.waitdeadline_ns, pid))
                s.wait_pushed[pid] = p.waitdeadline_ns

    @requires_lock("shard")
    def _enqueue(self, s: _ColonyShard, p: Process) -> None:
        # Blocked processes are side-lined entirely; they re-enter the ready
        # queues through requeue() when their last parent succeeds.
        if not p.queue_ready:
            return
        etype = p.spec.conditions.executortype
        entry = (p.priority_time, p.processid)
        targets = p.spec.conditions.executornames
        if targets:
            tmap = s.targeted.setdefault(etype, {})
            for name in targets:
                self._insort_unique(tmap.setdefault(name, []), entry)
        else:
            self._insort_unique(s.queues.setdefault(etype, []), entry)

    @staticmethod
    def _insort_unique(q: list[tuple[int, str]], entry: tuple[int, str]) -> None:
        idx = bisect.bisect_left(q, entry)
        if idx < len(q) and q[idx] == entry:
            return  # already queued (e.g. failsafe requeue racing a release)
        q.insert(idx, entry)

    # processes
    def add_process(self, p: Process) -> None:
        # Fault point BEFORE any lock (CONCURRENCY.md: nothing may raise
        # or sleep under a shard lock that isn't the write itself).
        faults.hit("db.commit", method="add_process")
        s = self._shard(p.colonyname)
        with s.lock:
            s.procs[p.processid] = p
            with self._glock:
                self._pid_colony[p.processid] = p.colonyname
            self._account(s, p)
            self._push_deadlines(s, p)
            self._enqueue(s, p)

    def get_process(self, processid: str) -> Process:
        with self._glock:
            colony = self._pid_colony.get(processid)
        if colony is None:
            raise NotFoundError(f"process {processid} not found")
        s = self._shard(colony)
        with s.lock:
            p = s.procs.get(processid)
            if p is None:
                raise NotFoundError(f"process {processid} not found")
            return p

    def update_process(self, p: Process) -> None:
        faults.hit("db.commit", method="update_process")
        s = self._shard(p.colonyname)
        with s.lock:
            if p.processid not in s.procs:
                raise NotFoundError("process not found")
            s.procs[p.processid] = p
            self._account(s, p)
            self._push_deadlines(s, p)

    def requeue(self, p: Process) -> None:
        """Re-insert a reset or released process into the ready queues."""
        s = self._shard(p.colonyname)
        with s.lock:
            self._push_deadlines(s, p)
            self._enqueue(s, p)

    # RPC dedup (exactly-once keyed RPCs; ROBUSTNESS.md). The reply is
    # snapshotted with ``marshal`` — a flat bytes blob, so (a) a caller
    # mutating the live result object can never corrupt the record, and
    # (b) the table is invisible to the cyclic GC. Both alternatives
    # measured worse on the hot path: storing the object graph by
    # reference kept thousands of long-lived containers on the gen-2
    # scan list (a per-cycle GC tax bigger than the marshal dump), and
    # JSON costs ~3x marshal to encode. Replies are plain JSON-shaped
    # data (dict/list/str/num/bool/None), exactly marshal's domain.
    def dedup_get(self, key: str) -> dict | None:
        with self._glock:
            rec = self._dedup.get(key)
            if rec is None:
                return None
            ts, _colony, blob = rec
            if now_ns() - ts > DEDUP_TTL_NS:
                del self._dedup[key]
                return None
        return marshal.loads(blob)

    def dedup_put(self, key: str, colony: str, ts: int, reply) -> None:
        """The record is stored before the eviction walks the colony's FIFO,
        whose prefix loop drops keys it cannot find: the reference stores it
        after, so the new key, alone in the FIFO, is always dropped and its
        table is never bounded."""
        blob = marshal.dumps(reply)
        with self._glock:
            fresh = key not in self._dedup
            self._dedup[key] = (ts, colony, blob)
            if fresh:
                fifo = self._dedup_fifo.get(colony)
                if fifo is None:
                    fifo = self._dedup_fifo[colony] = deque()
                fifo.append(key)
                # Amortized eviction: cap overflow plus any expired prefix.
                while len(fifo) > DEDUP_MAX_PER_COLONY:
                    self._dedup.pop(fifo.popleft(), None)
                while fifo:
                    head = self._dedup.get(fifo[0])
                    if head is None:
                        fifo.popleft()
                    elif ts - head[0] > DEDUP_TTL_NS:
                        del self._dedup[fifo.popleft()]
                    else:
                        break

    @requires_lock("shard")
    def _scan_queue(
        self,
        s: _ColonyShard,
        q: list[tuple[int, str]] | None,
        etype: str,
        executorname: str,
        limit: int,
        targeted: bool,
    ) -> list[Process]:
        """Collect up to ``limit`` ready processes from one sorted queue.

        Stale entries discovered in the scanned prefix are evicted in a
        single rebuild of that prefix — never one ``list.remove`` each.
        """
        if not q:
            return []
        out: list[Process] = []
        scanned = 0
        found_stale = False
        for _, pid in q:
            scanned += 1
            self.metrics["queue_scan_steps"] += 1
            p = s.procs.get(pid)
            ok = p is not None and p.queue_ready
            if ok and targeted:
                ok = executorname in p.spec.conditions.executornames
            elif ok and p.spec.conditions.executornames:
                ok = False  # targeted proc must never ride the shared queue
            if not ok:
                found_stale = True
                continue
            out.append(p)
            if len(out) >= limit:
                break
        if found_stale:

            def live(entry: tuple[int, str]) -> bool:
                lp = s.procs.get(entry[1])
                if lp is None or not lp.queue_ready:
                    return False
                if targeted:
                    return executorname in lp.spec.conditions.executornames
                return not lp.spec.conditions.executornames

            prefix = [e for e in q[:scanned] if live(e)]
            evicted = scanned - len(prefix)
            self.metrics["stale_evicted"] += evicted
            if evicted:
                s.stale[etype] = max(0, s.stale.get(etype, 0) - evicted)
            q[:scanned] = prefix
        return out

    def candidates(
        self, colony: str, executortype: str, executorname: str, limit: int = 8
    ) -> list[Process]:
        s = self._shard(colony)
        with s.lock:
            main = self._scan_queue(
                s,
                s.queues.get(executortype),
                executortype,
                executorname,
                limit,
                targeted=False,
            )
            side = self._scan_queue(
                s,
                s.targeted.get(executortype, {}).get(executorname),
                executortype,
                executorname,
                limit,
                targeted=True,
            )
            if not side:
                return main
            merged = sorted(main + side, key=lambda p: (p.priority_time, p.processid))
            return merged[:limit]

    def list_processes(
        self, colony: str, state: str | None = None, count: int = 100
    ) -> list[Process]:
        s = self._shard(colony)
        with s.lock:
            out = [
                p
                for p in s.procs.values()
                if state is None or p.state == state
            ]
            out.sort(key=lambda p: p.priority_time)
            return out[:count]

    @requires_lock("shard")
    def _pop_expired(
        self,
        s: _ColonyShard,
        heap: list[tuple[int, str]],
        pushed: dict[str, int],
        want_state: str,
        attr: str,
        ts: int,
    ) -> list[Process]:
        expired: list[Process] = []
        keep: list[tuple[int, str]] = []
        while heap and heap[0][0] < ts:
            deadline, pid = heapq.heappop(heap)
            self.metrics["deadline_pops"] += 1
            p = s.procs.get(pid)
            if p is not None and p.state == want_state and getattr(p, attr) == deadline:
                expired.append(p)
                keep.append((deadline, pid))  # caller mutates; entry goes stale then
            elif pushed.get(pid) == deadline:
                pushed.pop(pid, None)
        for entry in keep:
            heapq.heappush(heap, entry)
        return expired

    def running_past_deadline(self, ts: int) -> list[Process]:
        with self._glock:
            shards = list(self._shards.values())
        out: list[Process] = []
        for s in shards:
            with s.lock:
                out.extend(
                    self._pop_expired(
                        s, s.exec_heap, s.exec_pushed, RUNNING, "deadline_ns", ts
                    )
                )
        return out

    def waiting_past_deadline(self, ts: int) -> list[Process]:
        with self._glock:
            shards = list(self._shards.values())
        out: list[Process] = []
        for s in shards:
            with s.lock:
                out.extend(
                    self._pop_expired(
                        s, s.wait_heap, s.wait_pushed, WAITING, "waitdeadline_ns", ts
                    )
                )
        return out

    def delete_process(self, processid: str) -> None:
        with self._glock:
            colony = self._pid_colony.pop(processid, None)
        if colony is None:
            return
        s = self._shard(colony)
        with s.lock:
            p = s.procs.pop(processid, None)
            if p is None:
                return
            old = s.acct.pop(processid, None)
            if old is not None:
                s.counters[old] = s.counters.get(old, 0) - 1
            s.exec_pushed.pop(processid, None)
            s.wait_pushed.pop(processid, None)
            if old == WAITING:
                self._note_stale(s, p)

    def colony_stats(self, colony: str) -> dict[str, int]:
        s = self._shard(colony)
        with s.lock:
            return {state: n for state, n in s.counters.items() if n}

    def replica_state(self, colony: str) -> list[tuple]:
        s = self._shard(colony)
        with s.lock:
            return [process_state_tuple(p) for p in s.procs.values()]

    # -- CFS metadata -------------------------------------------------------
    @staticmethod
    @requires_lock("cfs")
    def _cfs_link(s: _CfsShard, label: str) -> None:
        """Wire a new label into the tree, up to the first existing edge."""
        while label != "/":
            parent = _cfs_parent(label)
            kids = s.children.setdefault(parent, set())
            if label in kids:
                return
            kids.add(label)
            label = parent

    @staticmethod
    @requires_lock("cfs")
    def _cfs_prune(s: _CfsShard, label: str) -> None:
        """Drop now-empty labels so the tree only holds live paths."""
        while label != "/" and not s.by_label.get(label) and not s.children.get(label):
            s.by_label.pop(label, None)
            s.children.pop(label, None)
            parent = _cfs_parent(label)
            kids = s.children.get(parent)
            if kids is not None:
                kids.discard(label)
            label = parent

    def cfs_add_file(self, entry: dict) -> dict:
        s = self._cfs(entry["colonyname"])
        label, name = entry["label"], entry["name"]
        with s.lock:
            new_label = label not in s.by_label and label not in s.children
            revs = s.by_label.setdefault(label, {}).setdefault(name, [])
            entry = dict(entry)
            entry["revision"] = (revs[-1][0] + 1) if revs else 1
            s.files[entry["fileid"]] = entry
            revs.append((entry["revision"], entry["fileid"]))
            if new_label:
                self._cfs_link(s, label)
            return dict(entry)

    def cfs_get_file(self, colony: str, fileid: str) -> dict | None:
        s = self._cfs(colony)
        with s.lock:
            e = s.files.get(fileid)
            return dict(e) if e is not None else None

    def cfs_get_files_by_ids(self, colony: str, fileids: list[str]) -> list[dict | None]:
        s = self._cfs(colony)
        with s.lock:  # one lock pass for the whole batch
            return [
                dict(e) if (e := s.files.get(fid)) is not None else None
                for fid in fileids
            ]

    def cfs_head(self, colony: str, label: str, name: str) -> dict | None:
        s = self._cfs(colony)
        with s.lock:
            revs = s.by_label.get(label, {}).get(name)
            return dict(s.files[revs[-1][1]]) if revs else None

    def cfs_list(self, colony: str, label: str) -> list[dict]:
        s = self._cfs(colony)
        with s.lock:
            return self._cfs_list_locked(s, label)

    @requires_lock("cfs")
    def _cfs_list_locked(self, s: _CfsShard, label: str) -> list[dict]:
        if label not in s.by_label and label not in s.children:
            return []
        out: list[dict] = []
        stack = [label]
        while stack:
            lbl = stack.pop()
            self.metrics["cfs_nodes_visited"] += 1
            for revs in s.by_label.get(lbl, {}).values():
                out.append(dict(s.files[revs[-1][1]]))
            stack.extend(s.children.get(lbl, ()))
        out.sort(key=lambda e: (e["label"], e["name"]))
        return out

    def cfs_remove_file(self, colony: str, fileid: str) -> dict | None:
        s = self._cfs(colony)
        with s.lock:
            e = s.files.get(fileid)
            if e is None:
                return None
            holders = s.pins.get(fileid)
            if holders:
                raise ConflictError(
                    "file revision pinned by snapshot " + next(iter(holders))
                )
            del s.files[fileid]
            names = s.by_label.get(e["label"], {})
            revs = names.get(e["name"], [])
            if (e["revision"], fileid) in revs:
                revs.remove((e["revision"], fileid))
            if not revs:
                names.pop(e["name"], None)
                if not names:
                    s.by_label.pop(e["label"], None)
                    self._cfs_prune(s, e["label"])
            return e

    def cfs_pin_count(self, colony: str, fileid: str) -> int:
        s = self._cfs(colony)
        with s.lock:
            return len(s.pins.get(fileid, ()))

    def cfs_create_snapshot(self, snap: dict) -> dict:
        s = self._cfs(snap["colonyname"])
        with s.lock:
            # Listing + pinning under one lock: a file removed concurrently
            # can never leave the snapshot holding a tombstone.
            snap = dict(snap)
            snap["fileids"] = [
                e["fileid"] for e in self._cfs_list_locked(s, snap["label"])
            ]
            s.snapshots[snap["snapshotid"]] = dict(snap)
            for fid in snap["fileids"]:
                s.pins.setdefault(fid, set()).add(snap["snapshotid"])
            return snap

    def cfs_get_snapshot(self, colony: str, snapshotid: str) -> dict | None:
        s = self._cfs(colony)
        with s.lock:
            snap = s.snapshots.get(snapshotid)
            return dict(snap) if snap is not None else None

    def cfs_list_snapshots(self, colony: str) -> list[dict]:
        s = self._cfs(colony)
        with s.lock:
            snaps = [dict(v) for v in s.snapshots.values()]
        snaps.sort(key=lambda e: (e.get("added", 0), e["snapshotid"]))
        return snaps

    def cfs_remove_snapshot(self, colony: str, snapshotid: str) -> dict | None:
        s = self._cfs(colony)
        with s.lock:
            snap = s.snapshots.pop(snapshotid, None)
            if snap is None:
                return None
            for fid in snap["fileids"]:
                holders = s.pins.get(fid)
                if holders is not None:
                    holders.discard(snapshotid)
                    if not holders:
                        del s.pins[fid]
            return snap

    # kv
    def kv_put(self, table: str, key: str, value: dict) -> None:
        with self._glock:
            self._kv.setdefault(table, {})[key] = dict(value)

    def kv_get(self, table: str, key: str) -> dict | None:
        with self._glock:
            v = self._kv.get(table, {}).get(key)
            return dict(v) if v is not None else None

    def kv_del(self, table: str, key: str) -> None:
        with self._glock:
            self._kv.get(table, {}).pop(key, None)

    def kv_list(self, table: str) -> list[dict]:
        with self._glock:
            return [dict(v) for v in self._kv.get(table, {}).values()]

    def kv_append(self, table: str, key: str, value: dict) -> int:
        with self._glock:
            lst = self._kvlists.setdefault(table, {}).setdefault(key, [])
            lst.append(dict(value))
            return len(lst)

    def kv_take_all(self, table: str, key: str) -> list[dict]:
        with self._glock:
            lst = self._kvlists.get(table, {}).pop(key, [])
            return lst

    def kv_len(self, table: str, key: str) -> int:
        with self._glock:
            return len(self._kvlists.get(table, {}).get(key, []))

    # cron / generator tables
    def cron_put(self, entry: dict) -> None:
        with self._glock:
            colony = entry["colonyname"]
            self._crons.setdefault(colony, {})[entry["cronid"]] = dict(entry)
            self._cron_colony[entry["cronid"]] = colony
            heapq.heappush(
                self._cron_heap, (entry.get("deadline", 0), entry["cronid"])
            )

    def cron_get(self, cronid: str) -> dict | None:
        with self._glock:
            colony = self._cron_colony.get(cronid)
            if colony is None:
                return None
            e = self._crons.get(colony, {}).get(cronid)
            return dict(e) if e is not None else None

    def cron_del(self, cronid: str) -> None:
        with self._glock:
            colony = self._cron_colony.pop(cronid, None)
            if colony is not None:
                self._crons.get(colony, {}).pop(cronid, None)
                # Heap entries go stale and are dropped lazily by cron_due.

    def cron_list(self, colony: str) -> list[dict]:
        with self._glock:
            entries = [dict(e) for e in self._crons.get(colony, {}).values()]
        entries.sort(key=lambda e: (e.get("added", 0), e["cronid"]))
        return entries

    def cron_due(self, ts: int) -> list[dict]:
        """Due entries via the deadline heap, dropping stale ones lazily.

        Still-live due entries are pushed back with their unchanged
        deadline: the caller fires and reschedules via cron_put (a new
        heap entry supersedes the pushed-back one), so a leader crash
        between due() and fire loses nothing — the next scan sees the
        entry again, exactly like sqlite's read-only range scan.
        """
        due: list[dict] = []
        keep: list[tuple[int, str]] = []
        with self._glock:
            while self._cron_heap and self._cron_heap[0][0] < ts:
                deadline, cronid = heapq.heappop(self._cron_heap)
                colony = self._cron_colony.get(cronid)
                e = self._crons.get(colony, {}).get(cronid) if colony else None
                if e is None or e.get("deadline", 0) != deadline:
                    continue  # removed or rescheduled: stale heap entry
                due.append(dict(e))
                keep.append((deadline, cronid))
            for item in keep:
                heapq.heappush(self._cron_heap, item)
        return due

    def generator_put(self, entry: dict) -> None:
        with self._glock:
            colony = entry["colonyname"]
            self._generators.setdefault(colony, {})[entry["generatorid"]] = dict(entry)
            self._generator_colony[entry["generatorid"]] = colony

    def generator_get(self, generatorid: str) -> dict | None:
        with self._glock:
            colony = self._generator_colony.get(generatorid)
            if colony is None:
                return None
            e = self._generators.get(colony, {}).get(generatorid)
            return dict(e) if e is not None else None

    def generator_del(self, generatorid: str) -> None:
        with self._glock:
            colony = self._generator_colony.pop(generatorid, None)
            if colony is not None:
                self._generators.get(colony, {}).pop(generatorid, None)

    def generator_list(self, colony: str) -> list[dict]:
        with self._glock:
            entries = [dict(e) for e in self._generators.get(colony, {}).values()]
        entries.sort(key=lambda e: (e.get("added", 0), e["generatorid"]))
        return entries

    def generator_all(self) -> list[dict]:
        with self._glock:
            return [
                dict(e)
                for per_colony in self._generators.values()
                for e in per_colony.values()
            ]

    # colony users
    def user_put(self, entry: dict) -> None:
        with self._glock:
            colony = entry["colonyname"]
            old = self._user_colony.get(entry["userid"])
            if old is not None and old != colony:
                self._users.get(old, {}).pop(entry["userid"], None)
            self._users.setdefault(colony, {})[entry["userid"]] = dict(entry)
            self._user_colony[entry["userid"]] = colony

    def user_get(self, userid: str) -> dict | None:
        with self._glock:
            colony = self._user_colony.get(userid)
            if colony is None:
                return None
            e = self._users.get(colony, {}).get(userid)
            return dict(e) if e is not None else None

    def user_del(self, userid: str) -> None:
        with self._glock:
            colony = self._user_colony.pop(userid, None)
            if colony is not None:
                self._users.get(colony, {}).pop(userid, None)

    def user_list(self, colony: str) -> list[dict]:
        with self._glock:
            entries = [dict(e) for e in self._users.get(colony, {}).values()]
        entries.sort(key=lambda e: (e.get("name", ""), e["userid"]))
        return entries


# ---------------------------------------------------------------------------
# Sqlite backend — the paper's SQL queue, verbatim semantics
# ---------------------------------------------------------------------------

_SCHEMA = """
CREATE TABLE IF NOT EXISTS colonies (
    colonyname TEXT PRIMARY KEY, colonyid TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS executors (
    executorid TEXT PRIMARY KEY, executorname TEXT, executortype TEXT,
    colonyname TEXT, state TEXT, commissiontime INTEGER, lastheardfrom INTEGER,
    capabilities TEXT,
    UNIQUE(colonyname, executorname)
);
CREATE TABLE IF NOT EXISTS functions (
    executorid TEXT, colonyname TEXT, funcname TEXT
);
CREATE TABLE IF NOT EXISTS processes (
    processid TEXT PRIMARY KEY,
    colonyname TEXT NOT NULL,
    executortype TEXT NOT NULL,
    state TEXT NOT NULL,
    waitforparents INTEGER NOT NULL DEFAULT 0,
    prioritytime INTEGER NOT NULL,
    deadline INTEGER NOT NULL DEFAULT 0,
    waitdeadline INTEGER NOT NULL DEFAULT 0,
    targets TEXT NOT NULL DEFAULT '',
    body TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_proc_queue
    ON processes (colonyname, executortype, state, waitforparents, prioritytime);
CREATE INDEX IF NOT EXISTS idx_proc_deadline ON processes (state, deadline);
CREATE INDEX IF NOT EXISTS idx_proc_waitdeadline ON processes (state, waitdeadline);
CREATE TABLE IF NOT EXISTS proc_counts (
    colonyname TEXT NOT NULL, state TEXT NOT NULL, n INTEGER NOT NULL,
    PRIMARY KEY (colonyname, state)
);
CREATE TABLE IF NOT EXISTS cfs_files (
    fileid TEXT PRIMARY KEY,
    colonyname TEXT NOT NULL,
    label TEXT NOT NULL,
    name TEXT NOT NULL,
    revision INTEGER NOT NULL,
    body TEXT NOT NULL
);
CREATE UNIQUE INDEX IF NOT EXISTS idx_cfs_head
    ON cfs_files (colonyname, label, name, revision);
CREATE TABLE IF NOT EXISTS cfs_snapshots (
    snapshotid TEXT PRIMARY KEY, colonyname TEXT NOT NULL, body TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_cfs_snap_colony ON cfs_snapshots (colonyname);
CREATE TABLE IF NOT EXISTS crons (
    cronid TEXT PRIMARY KEY, colonyname TEXT NOT NULL,
    deadline INTEGER NOT NULL DEFAULT 0, body TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_crons_colony ON crons (colonyname);
CREATE INDEX IF NOT EXISTS idx_crons_deadline ON crons (deadline);
CREATE TABLE IF NOT EXISTS generators (
    generatorid TEXT PRIMARY KEY, colonyname TEXT NOT NULL, body TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_generators_colony ON generators (colonyname);
CREATE TABLE IF NOT EXISTS users (
    userid TEXT PRIMARY KEY, colonyname TEXT NOT NULL, body TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_users_colony ON users (colonyname);
CREATE TABLE IF NOT EXISTS cfs_pins (
    colonyname TEXT NOT NULL, fileid TEXT NOT NULL, snapshotid TEXT NOT NULL,
    PRIMARY KEY (colonyname, fileid, snapshotid)
);
CREATE INDEX IF NOT EXISTS idx_cfs_pins_snap ON cfs_pins (colonyname, snapshotid);
CREATE TABLE IF NOT EXISTS kv (
    tbl TEXT NOT NULL, key TEXT NOT NULL, value TEXT NOT NULL,
    PRIMARY KEY (tbl, key)
);
CREATE TABLE IF NOT EXISTS kvlist (
    tbl TEXT NOT NULL, key TEXT NOT NULL, seq INTEGER NOT NULL, value TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_kvlist ON kvlist (tbl, key, seq);
CREATE TABLE IF NOT EXISTS rpc_dedup (
    key TEXT PRIMARY KEY, colonyname TEXT NOT NULL, ts INTEGER NOT NULL,
    reply TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_rpc_dedup_colony ON rpc_dedup (colonyname, ts);
"""


def _targets_column(p: Process) -> str:
    names = p.spec.conditions.executornames
    return "|" + "|".join(names) + "|" if names else ""


class SqliteDatabase(Database):
    """File-backed (or ``:memory:``) SQL queue.

    The candidate query is the paper's: ``ORDER BY prioritytime ASC`` over
    indexed (colony, executortype, state, waitforparents) columns, with
    executor targeting pushed into SQL so pinned processes never shadow
    the queue head for other executors. ``proc_counts`` is maintained
    transactionally with every process write, making ``colony_stats``
    independent of table size (and restart-safe).
    """

    def __init__(self, path: str = ":memory:") -> None:
        self._lock = make_lock("sqlite")
        self._colony_locks: dict[str, threading.RLock] = {}
        self._dedup_puts = 0  # amortized rpc_dedup eviction counter
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._migrate()
            self._conn.executescript(_SCHEMA)
            self._rebuild_counts_if_missing()
            self._migrate_cfs()
            self._migrate_cron_gen()
            self._migrate_users()
            self._conn.commit()

    def _migrate(self) -> None:
        """Add columns introduced after a db file was created."""
        cols = {
            r[1]
            for r in self._conn.execute("PRAGMA table_info(processes)").fetchall()
        }
        if cols and "targets" not in cols:
            self._conn.execute(
                "ALTER TABLE processes ADD COLUMN targets TEXT NOT NULL DEFAULT ''"
            )
            # Backfill from the body JSON: pre-migration rows kept executor
            # targeting only there, and a blank targets column would make a
            # pinned process assignable by anyone.
            rows = self._conn.execute(
                "SELECT processid, body FROM processes"
            ).fetchall()
            for pid, body in rows:
                t = _targets_column(Process.from_json(body))
                if t:
                    self._conn.execute(
                        "UPDATE processes SET targets=? WHERE processid=?", (t, pid)
                    )

    def _migrate_cfs(self) -> None:
        """Backfill first-class CFS tables from the seed's kv rows.

        Pre-index databases kept every file and snapshot as opaque JSON
        under kv(tbl='cfs_files'/'cfs_snapshots'); move them into the
        indexed tables (rebuilding pin rows from each snapshot's fileids)
        and drop the kv copies so there is a single source of truth. The
        kv bucket names below are frozen — they must match what old
        database files contain, regardless of future table renames.
        """
        rows = self._conn.execute(
            "SELECT value FROM kv WHERE tbl='cfs_files'"
        ).fetchall()
        for (val,) in rows:
            e = json.loads(val)
            exists = self._conn.execute(
                "SELECT 1 FROM cfs_files WHERE fileid=?", (e["fileid"],)
            ).fetchone()
            if exists:
                continue
            e["revision"] = int(e.get("revision", 1))
            try:
                self._conn.execute(
                    "INSERT INTO cfs_files VALUES (?,?,?,?,?,?)",
                    (
                        e["fileid"],
                        e["colonyname"],
                        e["label"],
                        e["name"],
                        e["revision"],
                        json.dumps(e),
                    ),
                )
            except sqlite3.IntegrityError:
                # The seed computed revisions without a lock, so two adds of
                # the same (label, name) could both claim revision N.
                # Re-sequence the loser past the current head instead of
                # silently dropping its metadata.
                head = self._conn.execute(
                    "SELECT MAX(revision) FROM cfs_files"
                    " WHERE colonyname=? AND label=? AND name=?",
                    (e["colonyname"], e["label"], e["name"]),
                ).fetchone()[0]
                e["revision"] = (head or 0) + 1
                self._conn.execute(
                    "INSERT INTO cfs_files VALUES (?,?,?,?,?,?)",
                    (
                        e["fileid"],
                        e["colonyname"],
                        e["label"],
                        e["name"],
                        e["revision"],
                        json.dumps(e),
                    ),
                )
        rows = self._conn.execute(
            "SELECT value FROM kv WHERE tbl='cfs_snapshots'"
        ).fetchall()
        for (val,) in rows:
            snap = json.loads(val)
            self._conn.execute(
                "INSERT OR IGNORE INTO cfs_snapshots VALUES (?,?,?)",
                (snap["snapshotid"], snap["colonyname"], json.dumps(snap)),
            )
            for fid in snap.get("fileids", []):
                self._conn.execute(
                    "INSERT OR IGNORE INTO cfs_pins VALUES (?,?,?)",
                    (snap["colonyname"], fid, snap["snapshotid"]),
                )
        self._conn.execute("DELETE FROM kv WHERE tbl IN ('cfs_files','cfs_snapshots')")

    def _migrate_cron_gen(self) -> None:
        """Backfill first-class cron/generator tables from the seed's kv rows.

        Same pattern as :meth:`_migrate_cfs`: pre-index databases stored
        cron and generator entries as opaque JSON under kv(tbl='crons') /
        kv(tbl='generators'); lift them into the indexed tables and drop
        the kv copies.
        """
        for (val,) in self._conn.execute(
            "SELECT value FROM kv WHERE tbl='crons'"
        ).fetchall():
            e = json.loads(val)
            self._conn.execute(
                "INSERT OR IGNORE INTO crons VALUES (?,?,?,?)",
                (
                    e["cronid"],
                    e["colonyname"],
                    int(e.get("deadline", 0)),
                    json.dumps(e),
                ),
            )
        for (val,) in self._conn.execute(
            "SELECT value FROM kv WHERE tbl='generators'"
        ).fetchall():
            e = json.loads(val)
            self._conn.execute(
                "INSERT OR IGNORE INTO generators VALUES (?,?,?)",
                (e["generatorid"], e["colonyname"], json.dumps(e)),
            )
        self._conn.execute("DELETE FROM kv WHERE tbl IN ('crons','generators')")

    def _migrate_users(self) -> None:
        """Backfill the first-class users table from the seed's kv rows.

        Same pattern as :meth:`_migrate_cron_gen`: pre-index databases
        stored colony users as opaque JSON under kv(tbl='users'), keyed
        by the user's identity; lift them into the indexed table and drop
        the kv copies.
        """
        for key, val in self._conn.execute(
            "SELECT key, value FROM kv WHERE tbl='users'"
        ).fetchall():
            e = json.loads(val)
            self._conn.execute(
                "INSERT OR IGNORE INTO users VALUES (?,?,?)",
                (e.get("userid", key), e.get("colonyname", ""), json.dumps(e)),
            )
        self._conn.execute("DELETE FROM kv WHERE tbl='users'")

    def _rebuild_counts_if_missing(self) -> None:
        have = self._conn.execute("SELECT COUNT(*) FROM proc_counts").fetchone()[0]
        procs = self._conn.execute("SELECT COUNT(*) FROM processes").fetchone()[0]
        if have == 0 and procs > 0:
            self._conn.execute(
                "INSERT INTO proc_counts"
                " SELECT colonyname, state, COUNT(*) FROM processes"
                " GROUP BY colonyname, state"
            )

    @requires_lock("sqlite")
    def _exec(self, sql: str, args: Iterable[Any] = ()) -> sqlite3.Cursor:
        return self._conn.execute(sql, tuple(args))

    def colony_lock(self, colony: str) -> threading.RLock:
        with self._lock:
            lk = self._colony_locks.get(colony)
            if lk is None:
                lk = self._colony_locks[colony] = make_lock(f"dbcolony:{colony}")
            return lk

    # colonies
    def add_colony(self, colony: Colony) -> None:
        with self._lock:
            try:
                self._exec(
                    "INSERT INTO colonies VALUES (?, ?)",
                    (colony.colonyname, colony.colonyid),
                )
                self._conn.commit()
            except sqlite3.IntegrityError as e:
                raise ConflictError(f"colony {colony.colonyname} exists") from e

    def get_colony(self, name: str) -> Colony:
        with self._lock:
            row = self._exec(
                "SELECT colonyname, colonyid FROM colonies WHERE colonyname=?", (name,)
            ).fetchone()
            if row is None:
                raise NotFoundError(f"colony {name} not found")
            return Colony(colonyname=row[0], colonyid=row[1])

    def list_colonies(self) -> list[Colony]:
        with self._lock:
            rows = self._exec("SELECT colonyname, colonyid FROM colonies").fetchall()
            return [Colony(colonyname=r[0], colonyid=r[1]) for r in rows]

    # executors
    def add_executor(self, ex: Executor) -> None:
        with self._lock:
            try:
                self._exec(
                    "INSERT INTO executors VALUES (?,?,?,?,?,?,?,?)",
                    (
                        ex.executorid,
                        ex.executorname,
                        ex.executortype,
                        ex.colonyname,
                        ex.state,
                        ex.commissiontime_ns,
                        ex.lastheardfrom_ns,
                        json.dumps(ex.capabilities),
                    ),
                )
                self._conn.commit()
            except sqlite3.IntegrityError as e:
                raise ConflictError("executor exists or name taken") from e

    @staticmethod
    def _row_to_executor(row: tuple) -> Executor:
        return Executor(
            executorid=row[0],
            executorname=row[1],
            executortype=row[2],
            colonyname=row[3],
            state=row[4],
            commissiontime_ns=row[5],
            lastheardfrom_ns=row[6],
            capabilities=json.loads(row[7] or "{}"),
        )

    def get_executor(self, executorid: str) -> Executor:
        with self._lock:
            row = self._exec(
                "SELECT * FROM executors WHERE executorid=?", (executorid,)
            ).fetchone()
            if row is None:
                raise NotFoundError("executor not found")
            return self._row_to_executor(row)

    def get_executor_by_name(self, colony: str, name: str) -> Executor:
        with self._lock:
            row = self._exec(
                "SELECT * FROM executors WHERE colonyname=? AND executorname=?",
                (colony, name),
            ).fetchone()
            if row is None:
                raise NotFoundError(f"executor {name} not found")
            return self._row_to_executor(row)

    def list_executors(self, colony: str) -> list[Executor]:
        with self._lock:
            rows = self._exec(
                "SELECT * FROM executors WHERE colonyname=?", (colony,)
            ).fetchall()
            return [self._row_to_executor(r) for r in rows]

    def set_executor_state(self, executorid: str, state: str) -> None:
        with self._lock:
            cur = self._exec(
                "UPDATE executors SET state=? WHERE executorid=?", (state, executorid)
            )
            if cur.rowcount == 0:
                raise NotFoundError("executor not found")
            self._conn.commit()

    def remove_executor(self, executorid: str) -> None:
        with self._lock:
            cur = self._exec("DELETE FROM executors WHERE executorid=?", (executorid,))
            if cur.rowcount == 0:
                raise NotFoundError("executor not found")
            self._conn.commit()

    def touch_executor(self, executorid: str, ts: int) -> None:
        with self._lock:
            self._exec(
                "UPDATE executors SET lastheardfrom=? WHERE executorid=?",
                (ts, executorid),
            )
            self._conn.commit()

    # functions
    def add_function(self, executorid: str, colony: str, funcname: str) -> None:
        with self._lock:
            self._exec(
                "INSERT INTO functions VALUES (?,?,?)", (executorid, colony, funcname)
            )
            self._conn.commit()

    def list_functions(self, colony: str, executorid: str | None = None) -> list[dict]:
        with self._lock:
            if executorid is None:
                rows = self._exec(
                    "SELECT executorid, colonyname, funcname FROM functions WHERE colonyname=?",
                    (colony,),
                ).fetchall()
            else:
                rows = self._exec(
                    "SELECT executorid, colonyname, funcname FROM functions"
                    " WHERE colonyname=? AND executorid=?",
                    (colony, executorid),
                ).fetchall()
            return [
                {"executorid": r[0], "colonyname": r[1], "funcname": r[2]} for r in rows
            ]

    # processes
    @requires_lock("sqlite")
    def _bump_count(self, colony: str, state: str, delta: int) -> None:
        self._exec(
            "INSERT INTO proc_counts VALUES (?,?,?)"
            " ON CONFLICT(colonyname,state) DO UPDATE SET n=n+excluded.n",
            (colony, state, delta),
        )

    @requires_lock("sqlite")
    def _write_process(self, p: Process, insert: bool) -> None:
        body = p.to_json()
        if insert:
            self._exec(
                "INSERT INTO processes VALUES (?,?,?,?,?,?,?,?,?,?)",
                (
                    p.processid,
                    p.colonyname,
                    p.spec.conditions.executortype,
                    p.state,
                    int(p.wait_for_parents),
                    p.priority_time,
                    p.deadline_ns,
                    p.waitdeadline_ns,
                    _targets_column(p),
                    body,
                ),
            )
            self._bump_count(p.colonyname, p.state, +1)
        else:
            old = self._exec(
                "SELECT state FROM processes WHERE processid=?", (p.processid,)
            ).fetchone()
            if old is None:
                raise NotFoundError("process not found")
            self._exec(
                "UPDATE processes SET state=?, waitforparents=?, prioritytime=?,"
                " deadline=?, waitdeadline=?, targets=?, body=? WHERE processid=?",
                (
                    p.state,
                    int(p.wait_for_parents),
                    p.priority_time,
                    p.deadline_ns,
                    p.waitdeadline_ns,
                    _targets_column(p),
                    body,
                    p.processid,
                ),
            )
            if old[0] != p.state:
                self._bump_count(p.colonyname, old[0], -1)
                self._bump_count(p.colonyname, p.state, +1)
        self._conn.commit()

    def add_process(self, p: Process) -> None:
        # Fault point BEFORE the lock: an injected commit failure must not
        # abandon a held sqlite lock or a half-written transaction.
        faults.hit("db.commit", method="add_process")
        with self._lock:
            self._write_process(p, insert=True)

    def get_process(self, processid: str) -> Process:
        with self._lock:
            row = self._exec(
                "SELECT body FROM processes WHERE processid=?", (processid,)
            ).fetchone()
            if row is None:
                raise NotFoundError(f"process {processid} not found")
            return Process.from_json(row[0])

    def update_process(self, p: Process) -> None:
        faults.hit("db.commit", method="update_process")
        with self._lock:
            self._write_process(p, insert=False)

    def candidates(
        self, colony: str, executortype: str, executorname: str, limit: int = 8
    ) -> list[Process]:
        with self._lock:
            # The paper's queue query (§3.3): the table *is* the queue.
            # Targeting is part of the WHERE clause, so a process pinned to
            # another executor can never occupy this executor's queue head.
            rows = self._exec(
                "SELECT body FROM processes"
                " WHERE colonyname=? AND executortype=? AND state=? AND waitforparents=0"
                " AND (targets='' OR instr(targets, ?) > 0)"
                " ORDER BY prioritytime ASC LIMIT ?",
                (colony, executortype, WAITING, f"|{executorname}|", limit),
            ).fetchall()
            return [Process.from_json(body) for (body,) in rows]

    def list_processes(
        self, colony: str, state: str | None = None, count: int = 100
    ) -> list[Process]:
        with self._lock:
            if state is None:
                rows = self._exec(
                    "SELECT body FROM processes WHERE colonyname=?"
                    " ORDER BY prioritytime ASC LIMIT ?",
                    (colony, count),
                ).fetchall()
            else:
                rows = self._exec(
                    "SELECT body FROM processes WHERE colonyname=? AND state=?"
                    " ORDER BY prioritytime ASC LIMIT ?",
                    (colony, state, count),
                ).fetchall()
            return [Process.from_json(r[0]) for r in rows]

    def running_past_deadline(self, ts: int) -> list[Process]:
        with self._lock:
            # Range scan on idx_proc_deadline (state, deadline): O(expired).
            rows = self._exec(
                "SELECT body FROM processes WHERE state=? AND deadline>0 AND deadline<?",
                (RUNNING, ts),
            ).fetchall()
            return [Process.from_json(r[0]) for r in rows]

    def waiting_past_deadline(self, ts: int) -> list[Process]:
        with self._lock:
            # Range scan on idx_proc_waitdeadline (state, waitdeadline).
            rows = self._exec(
                "SELECT body FROM processes WHERE state=? AND waitdeadline>0 AND waitdeadline<?",
                (WAITING, ts),
            ).fetchall()
            return [Process.from_json(r[0]) for r in rows]

    def delete_process(self, processid: str) -> None:
        with self._lock:
            row = self._exec(
                "SELECT colonyname, state FROM processes WHERE processid=?",
                (processid,),
            ).fetchone()
            if row is None:
                return
            self._exec("DELETE FROM processes WHERE processid=?", (processid,))
            self._bump_count(row[0], row[1], -1)
            self._conn.commit()

    def colony_stats(self, colony: str) -> dict[str, int]:
        with self._lock:
            rows = self._exec(
                "SELECT state, n FROM proc_counts WHERE colonyname=? AND n>0",
                (colony,),
            ).fetchall()
            return {r[0]: r[1] for r in rows}

    def replica_state(self, colony: str) -> list[tuple]:
        with self._lock:
            rows = self._exec(
                "SELECT body FROM processes WHERE colonyname=?", (colony,)
            ).fetchall()
            return [process_state_tuple(Process.from_json(r[0])) for r in rows]

    def requeue(self, p: Process) -> None:  # row update already re-queues in SQL
        pass

    # -- RPC dedup (exactly-once keyed RPCs; ROBUSTNESS.md) -----------------

    def dedup_get(self, key: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT ts, reply FROM rpc_dedup WHERE key=?", (key,)
            ).fetchone()
            if row is None or now_ns() - row[0] > DEDUP_TTL_NS:
                return None
            return json.loads(row[1])

    def dedup_put(self, key: str, colony: str, ts: int, reply) -> None:
        with self._lock:
            self._exec(
                "INSERT OR REPLACE INTO rpc_dedup VALUES (?,?,?,?)",
                (key, colony, ts, json.dumps(reply)),
            )
            # Amortized eviction (~1/128 puts): expired rows everywhere,
            # plus cap overflow in this colony via idx_rpc_dedup_colony.
            self._dedup_puts += 1
            if self._dedup_puts % 128 == 0:
                self._exec("DELETE FROM rpc_dedup WHERE ts<?", (ts - DEDUP_TTL_NS,))
                self._exec(
                    "DELETE FROM rpc_dedup WHERE key IN ("
                    " SELECT key FROM rpc_dedup WHERE colonyname=?"
                    " ORDER BY ts DESC LIMIT -1 OFFSET ?)",
                    (colony, DEDUP_MAX_PER_COLONY),
                )
            # The commit must happen per put: the handler's effect already
            # committed before this call, so without it this INSERT would
            # open a fresh write transaction and hold the file's RESERVED
            # lock indefinitely — any other connection to the same
            # database (broker restart, a second broker in the paper's
            # shared-DB model) hits "database is locked". A crash between
            # the effect commit and this one loses only the dedup record,
            # which re-executes the op on retry — the same outcome an
            # unkeyed retry produces (ROBUSTNESS.md).
            self._conn.commit()

    # -- CFS metadata -------------------------------------------------------

    def cfs_add_file(self, entry: dict) -> dict:
        with self._lock:
            row = self._exec(
                "SELECT revision FROM cfs_files"
                " WHERE colonyname=? AND label=? AND name=?"
                " ORDER BY revision DESC LIMIT 1",
                (entry["colonyname"], entry["label"], entry["name"]),
            ).fetchone()
            entry = dict(entry)
            entry["revision"] = (row[0] + 1) if row else 1
            self._exec(
                "INSERT INTO cfs_files VALUES (?,?,?,?,?,?)",
                (
                    entry["fileid"],
                    entry["colonyname"],
                    entry["label"],
                    entry["name"],
                    entry["revision"],
                    json.dumps(entry),
                ),
            )
            self._conn.commit()
            return entry

    def cfs_get_file(self, colony: str, fileid: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT body FROM cfs_files WHERE fileid=? AND colonyname=?",
                (fileid, colony),
            ).fetchone()
            return json.loads(row[0]) if row else None

    def cfs_get_files_by_ids(self, colony: str, fileids: list[str]) -> list[dict | None]:
        found: dict[str, dict] = {}
        with self._lock:
            # chunked to stay under sqlite's bound-parameter limit
            for i in range(0, len(fileids), 500):
                chunk = fileids[i : i + 500]
                ph = ",".join("?" * len(chunk))
                rows = self._exec(
                    f"SELECT fileid, body FROM cfs_files"
                    f" WHERE colonyname=? AND fileid IN ({ph})",
                    (colony, *chunk),
                ).fetchall()
                for fid, body in rows:
                    found[fid] = json.loads(body)
        return [found.get(fid) for fid in fileids]

    def cfs_head(self, colony: str, label: str, name: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT body FROM cfs_files"
                " WHERE colonyname=? AND label=? AND name=?"
                " ORDER BY revision DESC LIMIT 1",
                (colony, label, name),
            ).fetchone()
            return json.loads(row[0]) if row else None

    @requires_lock("sqlite")
    def _cfs_list_locked(self, colony: str, label: str) -> list[dict]:
        # Two range probes of idx_cfs_head (an OR'd predicate makes sqlite
        # fall back to scanning the whole colony prefix): the label itself,
        # then its descendants — exactly [label+'/', label+'0'), '0' being
        # the code point after '/'. The exact-label rows sort first, so
        # concatenation preserves (label, name) order. sqlite's
        # bare-column-with-MAX rule makes body the head revision's body.
        out = [
            json.loads(r[0])
            for r in self._exec(
                "SELECT body, MAX(revision) FROM cfs_files"
                " WHERE colonyname=? AND label=? GROUP BY name ORDER BY name",
                (colony, label),
            ).fetchall()
        ]
        # Strict lower bound: normalized labels never end in '/', so this
        # drops nothing for non-root prefixes and keeps the root itself
        # out of its own descendant range.
        lo, hi = (("/", "0") if label == "/" else (label + "/", label + "0"))
        out += [
            json.loads(r[0])
            for r in self._exec(
                "SELECT body, MAX(revision) FROM cfs_files"
                " WHERE colonyname=? AND label>? AND label<?"
                " GROUP BY label, name ORDER BY label, name",
                (colony, lo, hi),
            ).fetchall()
        ]
        return out

    def cfs_list(self, colony: str, label: str) -> list[dict]:
        with self._lock:
            return self._cfs_list_locked(colony, label)

    def cfs_remove_file(self, colony: str, fileid: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT body FROM cfs_files WHERE fileid=? AND colonyname=?",
                (fileid, colony),
            ).fetchone()
            if row is None:
                return None
            pin = self._exec(
                "SELECT snapshotid FROM cfs_pins WHERE colonyname=? AND fileid=? LIMIT 1",
                (colony, fileid),
            ).fetchone()
            if pin is not None:
                raise ConflictError("file revision pinned by snapshot " + pin[0])
            self._exec("DELETE FROM cfs_files WHERE fileid=?", (fileid,))
            self._conn.commit()
            return json.loads(row[0])

    def cfs_pin_count(self, colony: str, fileid: str) -> int:
        with self._lock:
            return self._exec(
                "SELECT COUNT(*) FROM cfs_pins WHERE colonyname=? AND fileid=?",
                (colony, fileid),
            ).fetchone()[0]

    def cfs_create_snapshot(self, snap: dict) -> dict:
        with self._lock:
            snap = dict(snap)
            snap["fileids"] = [
                e["fileid"] for e in self._cfs_list_locked(snap["colonyname"], snap["label"])
            ]
            self._exec(
                "INSERT INTO cfs_snapshots VALUES (?,?,?)",
                (snap["snapshotid"], snap["colonyname"], json.dumps(snap)),
            )
            self._conn.executemany(
                "INSERT OR IGNORE INTO cfs_pins VALUES (?,?,?)",
                [(snap["colonyname"], fid, snap["snapshotid"]) for fid in snap["fileids"]],
            )
            self._conn.commit()
            return snap

    def cfs_get_snapshot(self, colony: str, snapshotid: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT body FROM cfs_snapshots WHERE snapshotid=? AND colonyname=?",
                (snapshotid, colony),
            ).fetchone()
            return json.loads(row[0]) if row else None

    def cfs_list_snapshots(self, colony: str) -> list[dict]:
        with self._lock:
            rows = self._exec(
                "SELECT body FROM cfs_snapshots WHERE colonyname=?", (colony,)
            ).fetchall()
        snaps = [json.loads(r[0]) for r in rows]
        snaps.sort(key=lambda e: (e.get("added", 0), e["snapshotid"]))
        return snaps

    def cfs_remove_snapshot(self, colony: str, snapshotid: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT body FROM cfs_snapshots WHERE snapshotid=? AND colonyname=?",
                (snapshotid, colony),
            ).fetchone()
            if row is None:
                return None
            self._exec("DELETE FROM cfs_snapshots WHERE snapshotid=?", (snapshotid,))
            self._exec(
                "DELETE FROM cfs_pins WHERE colonyname=? AND snapshotid=?",
                (colony, snapshotid),
            )
            self._conn.commit()
            return json.loads(row[0])

    # kv
    def kv_put(self, table: str, key: str, value: dict) -> None:
        with self._lock:
            self._exec(
                "INSERT INTO kv VALUES (?,?,?) ON CONFLICT(tbl,key) DO UPDATE SET value=excluded.value",
                (table, key, json.dumps(value)),
            )
            self._conn.commit()

    def kv_get(self, table: str, key: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT value FROM kv WHERE tbl=? AND key=?", (table, key)
            ).fetchone()
            return json.loads(row[0]) if row else None

    def kv_del(self, table: str, key: str) -> None:
        with self._lock:
            self._exec("DELETE FROM kv WHERE tbl=? AND key=?", (table, key))
            self._conn.commit()

    def kv_list(self, table: str) -> list[dict]:
        with self._lock:
            rows = self._exec("SELECT value FROM kv WHERE tbl=?", (table,)).fetchall()
            return [json.loads(r[0]) for r in rows]

    def kv_append(self, table: str, key: str, value: dict) -> int:
        with self._lock:
            row = self._exec(
                "SELECT COALESCE(MAX(seq), -1) FROM kvlist WHERE tbl=? AND key=?",
                (table, key),
            ).fetchone()
            seq = row[0] + 1
            self._exec(
                "INSERT INTO kvlist VALUES (?,?,?,?)",
                (table, key, seq, json.dumps(value)),
            )
            self._conn.commit()
            cnt = self._exec(
                "SELECT COUNT(*) FROM kvlist WHERE tbl=? AND key=?", (table, key)
            ).fetchone()[0]
            return cnt

    def kv_take_all(self, table: str, key: str) -> list[dict]:
        with self._lock:
            rows = self._exec(
                "SELECT value FROM kvlist WHERE tbl=? AND key=? ORDER BY seq",
                (table, key),
            ).fetchall()
            self._exec("DELETE FROM kvlist WHERE tbl=? AND key=?", (table, key))
            self._conn.commit()
            return [json.loads(r[0]) for r in rows]

    def kv_len(self, table: str, key: str) -> int:
        with self._lock:
            return self._exec(
                "SELECT COUNT(*) FROM kvlist WHERE tbl=? AND key=?", (table, key)
            ).fetchone()[0]

    # cron / generator tables
    def cron_put(self, entry: dict) -> None:
        with self._lock:
            self._exec(
                "INSERT INTO crons VALUES (?,?,?,?) ON CONFLICT(cronid)"
                " DO UPDATE SET deadline=excluded.deadline, body=excluded.body",
                (
                    entry["cronid"],
                    entry["colonyname"],
                    int(entry.get("deadline", 0)),
                    json.dumps(entry),
                ),
            )
            self._conn.commit()

    def cron_get(self, cronid: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT body FROM crons WHERE cronid=?", (cronid,)
            ).fetchone()
            return json.loads(row[0]) if row else None

    def cron_del(self, cronid: str) -> None:
        with self._lock:
            self._exec("DELETE FROM crons WHERE cronid=?", (cronid,))
            self._conn.commit()

    def cron_list(self, colony: str) -> list[dict]:
        with self._lock:
            rows = self._exec(
                "SELECT body FROM crons WHERE colonyname=?", (colony,)
            ).fetchall()
        entries = [json.loads(r[0]) for r in rows]
        entries.sort(key=lambda e: (e.get("added", 0), e["cronid"]))
        return entries

    def cron_due(self, ts: int) -> list[dict]:
        with self._lock:
            # Range scan on idx_crons_deadline: O(due), not O(crons).
            rows = self._exec(
                "SELECT body FROM crons WHERE deadline<? ORDER BY deadline", (ts,)
            ).fetchall()
        return [json.loads(r[0]) for r in rows]

    def generator_put(self, entry: dict) -> None:
        with self._lock:
            self._exec(
                "INSERT INTO generators VALUES (?,?,?) ON CONFLICT(generatorid)"
                " DO UPDATE SET body=excluded.body",
                (entry["generatorid"], entry["colonyname"], json.dumps(entry)),
            )
            self._conn.commit()

    def generator_get(self, generatorid: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT body FROM generators WHERE generatorid=?", (generatorid,)
            ).fetchone()
            return json.loads(row[0]) if row else None

    def generator_del(self, generatorid: str) -> None:
        with self._lock:
            self._exec("DELETE FROM generators WHERE generatorid=?", (generatorid,))
            self._conn.commit()

    def generator_list(self, colony: str) -> list[dict]:
        with self._lock:
            rows = self._exec(
                "SELECT body FROM generators WHERE colonyname=?", (colony,)
            ).fetchall()
        entries = [json.loads(r[0]) for r in rows]
        entries.sort(key=lambda e: (e.get("added", 0), e["generatorid"]))
        return entries

    def generator_all(self) -> list[dict]:
        with self._lock:
            rows = self._exec("SELECT body FROM generators").fetchall()
            return [json.loads(r[0]) for r in rows]

    # colony users
    def user_put(self, entry: dict) -> None:
        with self._lock:
            self._exec(
                "INSERT INTO users VALUES (?,?,?) ON CONFLICT(userid)"
                " DO UPDATE SET colonyname=excluded.colonyname, body=excluded.body",
                (entry["userid"], entry["colonyname"], json.dumps(entry)),
            )
            self._conn.commit()

    def user_get(self, userid: str) -> dict | None:
        with self._lock:
            row = self._exec(
                "SELECT body FROM users WHERE userid=?", (userid,)
            ).fetchone()
            return json.loads(row[0]) if row else None

    def user_del(self, userid: str) -> None:
        with self._lock:
            self._exec("DELETE FROM users WHERE userid=?", (userid,))
            self._conn.commit()

    def user_list(self, colony: str) -> list[dict]:
        with self._lock:
            rows = self._exec(
                "SELECT body FROM users WHERE colonyname=?", (colony,)
            ).fetchall()
        entries = [json.loads(r[0]) for r in rows]
        entries.sort(key=lambda e: (e.get("name", ""), e["userid"]))
        return entries
