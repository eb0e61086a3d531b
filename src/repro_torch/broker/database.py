"""The broker's in-memory database, trimmed from the reference's
``repro/core/database.py`` (``MemoryDatabase``).

The queue is a table (paper §3.2-3.3): assignment picks the ready
process of the executor's type with the smallest ``priority_time``
(Eq. 1), and a process that names executors goes only to those. The
reference keeps sorted ready queues, deadline heaps and per-state
counters so that its broker benchmarks do bounded work at any table
size; this copy answers the same queries by scanning one colony's
processes, which is what a single deployment of a few executors needs.

Locking follows the reference: every mutation of one colony's processes
(assign, close, failsafe) runs under that colony's ``colony_lock``, and
the registries sit behind one leaf lock that nothing is called under.
"""

from __future__ import annotations

import marshal
import threading
from dataclasses import dataclass, field
from typing import Any

from ..core.errors import ConflictError, NotFoundError
from ..core.process import RUNNING, WAITING, Process, now_ns
from .statehash import process_state_tuple

# A dedup record only needs to outlive its client's retry window.
DEDUP_TTL_NS = 600 * 10**9
DEDUP_MAX = 4096


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


def _under(label: str, root: str) -> bool:
    return root == "/" or label == root or label.startswith(root + "/")


class MemoryDatabase:
    def __init__(self) -> None:
        self._glock = threading.Lock()  # registries only; a leaf lock
        self._colony_locks: dict[str, threading.RLock] = {}
        self._colonies: dict[str, Colony] = {}
        self._executors: dict[str, Executor] = {}
        self._functions: list[dict] = []
        self._users: dict[str, dict] = {}
        self._procs: dict[str, dict[str, Process]] = {}  # colony -> pid -> process
        self._pid_colony: dict[str, str] = {}
        self._dedup: dict[str, tuple[int, bytes]] = {}  # in insertion order
        self._files: dict[str, dict[str, dict]] = {}  # colony -> fileid -> entry
        self._snapshots: dict[str, dict[str, dict]] = {}  # colony -> snapshotid -> snap
        self._generators: dict[str, dict] = {}
        self._packs: dict[str, list[dict]] = {}
        self._crons: dict[str, dict] = {}

    def colony_lock(self, colony: str) -> threading.RLock:
        with self._glock:
            lk = self._colony_locks.get(colony)
            if lk is None:
                lk = self._colony_locks[colony] = threading.RLock()
            return lk

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

    # executors
    def add_executor(self, ex: Executor) -> None:
        with self._glock:
            if ex.executorid in self._executors:
                raise ConflictError("executor exists")
            for other in self._executors.values():
                if other.colonyname == ex.colonyname and other.executorname == ex.executorname:
                    raise ConflictError(f"executor name {ex.executorname} taken")
            self._executors[ex.executorid] = ex

    def get_executor(self, executorid: str) -> Executor:
        with self._glock:
            ex = self._executors.get(executorid)
            if ex is None:
                raise NotFoundError("executor not found")
            return ex

    def list_executors(self, colony: str) -> list[Executor]:
        with self._glock:
            return [e for e in self._executors.values() if e.colonyname == colony]

    def set_executor_state(self, executorid: str, state: str) -> None:
        self.get_executor(executorid).state = state

    def remove_executor(self, executorid: str) -> None:
        with self._glock:
            if self._executors.pop(executorid, None) is None:
                raise NotFoundError("executor not found")

    def touch_executor(self, executorid: str, ts: int) -> None:
        with self._glock:
            ex = self._executors.get(executorid)
            if ex is not None:
                ex.lastheardfrom_ns = ts

    # functions
    def add_function(self, executorid: str, colony: str, funcname: str) -> None:
        with self._glock:
            self._functions.append(
                {"executorid": executorid, "colonyname": colony, "funcname": funcname})

    def list_functions(self, colony: str, executorid: str | None = None) -> list[dict]:
        with self._glock:
            return [dict(f) for f in self._functions if f["colonyname"] == colony
                    and (executorid is None or f["executorid"] == executorid)]

    # colony users
    def user_put(self, entry: dict) -> None:
        with self._glock:
            self._users[entry["userid"]] = dict(entry)

    def user_get(self, userid: str) -> dict | None:
        with self._glock:
            e = self._users.get(userid)
            return dict(e) if e is not None else None

    def user_list(self, colony: str) -> list[dict]:
        with self._glock:
            entries = [dict(e) for e in self._users.values() if e["colonyname"] == colony]
        entries.sort(key=lambda e: (e.get("name", ""), e["userid"]))
        return entries

    # processes: stored by reference, mutated under the colony lock
    def add_process(self, p: Process) -> None:
        with self.colony_lock(p.colonyname), self._glock:
            self._procs.setdefault(p.colonyname, {})[p.processid] = p
            self._pid_colony[p.processid] = p.colonyname

    def get_process(self, processid: str) -> Process:
        with self._glock:
            colony = self._pid_colony.get(processid)
            p = self._procs.get(colony, {}).get(processid) if colony is not None else None
        if p is None:
            raise NotFoundError(f"process {processid} not found")
        return p

    def update_process(self, p: Process) -> None:
        with self.colony_lock(p.colonyname), self._glock:
            procs = self._procs.get(p.colonyname, {})
            if p.processid not in procs:
                raise NotFoundError("process not found")
            procs[p.processid] = p

    def _colony_procs(self, colony: str) -> list[Process]:
        with self._glock:
            return list(self._procs.get(colony, {}).values())

    def candidates(self, colony: str, executortype: str, executorname: str,
                   limit: int = 8) -> list[Process]:
        """The ready processes this executor may take, oldest
        ``priority_time`` first: untargeted ones of its type, and those
        that name it."""
        with self.colony_lock(colony):
            ready = [p for p in self._colony_procs(colony)
                     if p.queue_ready and p.spec.conditions.executortype == executortype
                     and (not p.spec.conditions.executornames
                          or executorname in p.spec.conditions.executornames)]
        ready.sort(key=lambda p: (p.priority_time, p.processid))
        return ready[:limit]

    def list_processes(self, colony: str, state: str | None = None,
                       count: int = 100) -> list[Process]:
        with self.colony_lock(colony):
            out = [p for p in self._colony_procs(colony) if state is None or p.state == state]
        out.sort(key=lambda p: p.priority_time)
        return out[:count]

    def _past(self, ts: int, state: str, attr: str) -> list[Process]:
        with self._glock:
            colonies = list(self._procs)
        out = []
        for colony in colonies:
            with self.colony_lock(colony):
                out += [p for p in self._colony_procs(colony)
                        if p.state == state and 0 < getattr(p, attr) < ts]
        return out

    def running_past_deadline(self, ts: int) -> list[Process]:
        return self._past(ts, RUNNING, "deadline_ns")

    def waiting_past_deadline(self, ts: int) -> list[Process]:
        return self._past(ts, WAITING, "waitdeadline_ns")

    def replica_state(self, colony: str) -> list[tuple]:
        """Replication-visible rows of one colony (``statehash``'s
        ``process_state_tuple`` of each process), for digest cross-checks."""
        with self.colony_lock(colony):
            return [process_state_tuple(p) for p in self._colony_procs(colony)]

    def colony_stats(self, colony: str) -> dict[str, int]:
        stats: dict[str, int] = {}
        with self.colony_lock(colony):
            for p in self._colony_procs(colony):
                stats[p.state] = stats.get(p.state, 0) + 1
        return stats

    # RPC dedup (exactly-once keyed RPCs). The reply is kept as a
    # ``marshal`` snapshot, so a caller mutating the live result can
    # never change the record.
    def dedup_get(self, key: str) -> Any:
        with self._glock:
            rec = self._dedup.get(key)
            if rec is None:
                return None
            if now_ns() - rec[0] > DEDUP_TTL_NS:
                del self._dedup[key]
                return None
        return marshal.loads(rec[1])

    def dedup_put(self, key: str, ts: int, reply: Any) -> None:
        blob = marshal.dumps(reply)
        with self._glock:
            self._dedup[key] = (ts, blob)
            while self._dedup:
                oldest = next(iter(self._dedup))
                if len(self._dedup) <= DEDUP_MAX and ts - self._dedup[oldest][0] <= DEDUP_TTL_NS:
                    break
                del self._dedup[oldest]

    # CFS metadata: revisions of (label, name), snapshots pinning revisions
    def _heads(self, colony: str, root: str) -> list[dict]:
        heads: dict[tuple[str, str], dict] = {}
        for e in self._files.get(colony, {}).values():
            if _under(e["label"], root):
                key = (e["label"], e["name"])
                if key not in heads or e["revision"] > heads[key]["revision"]:
                    heads[key] = e
        return [dict(heads[k]) for k in sorted(heads)]

    def cfs_add_file(self, entry: dict) -> dict:
        with self._glock:
            files = self._files.setdefault(entry["colonyname"], {})
            revs = [e["revision"] for e in files.values()
                    if e["label"] == entry["label"] and e["name"] == entry["name"]]
            entry = dict(entry, revision=max(revs, default=0) + 1)
            files[entry["fileid"]] = entry
            return dict(entry)

    def cfs_get_file(self, colony: str, fileid: str) -> dict | None:
        with self._glock:
            e = self._files.get(colony, {}).get(fileid)
            return dict(e) if e is not None else None

    def cfs_get_files_by_ids(self, colony: str, fileids: list[str]) -> list[dict | None]:
        with self._glock:
            files = self._files.get(colony, {})
            return [dict(files[f]) if f in files else None for f in fileids]

    def cfs_head(self, colony: str, label: str, name: str) -> dict | None:
        with self._glock:
            heads = [e for e in self._heads(colony, label)
                     if e["label"] == label and e["name"] == name]
            return heads[0] if heads else None

    def cfs_list(self, colony: str, label: str) -> list[dict]:
        with self._glock:
            return self._heads(colony, label)

    def cfs_remove_file(self, colony: str, fileid: str) -> dict | None:
        with self._glock:
            files = self._files.get(colony, {})
            if fileid not in files:
                return None
            for snap in self._snapshots.get(colony, {}).values():
                if fileid in snap["fileids"]:
                    raise ConflictError("file revision pinned by snapshot " + snap["snapshotid"])
            return files.pop(fileid)

    def cfs_create_snapshot(self, snap: dict) -> dict:
        with self._glock:  # listing and pinning in one step
            snap = dict(snap, fileids=[e["fileid"] for e in
                                       self._heads(snap["colonyname"], snap["label"])])
            self._snapshots.setdefault(snap["colonyname"], {})[snap["snapshotid"]] = snap
            return dict(snap)

    def cfs_get_snapshot(self, colony: str, snapshotid: str) -> dict | None:
        with self._glock:
            snap = self._snapshots.get(colony, {}).get(snapshotid)
            return dict(snap) if snap is not None else None

    def cfs_list_snapshots(self, colony: str) -> list[dict]:
        with self._glock:
            snaps = [dict(v) for v in self._snapshots.get(colony, {}).values()]
        snaps.sort(key=lambda e: (e.get("added", 0), e["snapshotid"]))
        return snaps

    def cfs_remove_snapshot(self, colony: str, snapshotid: str) -> dict | None:
        with self._glock:
            return self._snapshots.get(colony, {}).pop(snapshotid, None)

    # generators and their packed args
    def generator_put(self, entry: dict) -> None:
        with self._glock:
            self._generators[entry["generatorid"]] = dict(entry)

    def generator_get(self, generatorid: str) -> dict | None:
        with self._glock:
            e = self._generators.get(generatorid)
            return dict(e) if e is not None else None

    def generator_del(self, generatorid: str) -> None:
        with self._glock:
            self._generators.pop(generatorid, None)
            self._packs.pop(generatorid, None)

    def generator_list(self, colony: str) -> list[dict]:
        with self._glock:
            entries = [dict(e) for e in self._generators.values() if e["colonyname"] == colony]
        entries.sort(key=lambda e: (e.get("added", 0), e["generatorid"]))
        return entries

    def generator_all(self) -> list[dict]:
        with self._glock:
            return [dict(e) for e in self._generators.values()]

    def pack_append(self, generatorid: str, value: dict) -> int:
        with self._glock:
            packs = self._packs.setdefault(generatorid, [])
            packs.append(dict(value))
            return len(packs)

    def pack_len(self, generatorid: str) -> int:
        with self._glock:
            return len(self._packs.get(generatorid, []))

    def pack_take_all(self, generatorid: str) -> list[dict]:
        with self._glock:
            return self._packs.pop(generatorid, [])

    # the cron table (the leader's two-step protocol, broker/cron.py)
    def cron_put(self, entry: dict) -> None:
        with self._glock:
            self._crons[entry["cronid"]] = dict(entry)

    def cron_get(self, cronid: str) -> dict | None:
        with self._glock:
            e = self._crons.get(cronid)
            return dict(e) if e is not None else None

    def cron_del(self, cronid: str) -> None:
        with self._glock:
            self._crons.pop(cronid, None)

    def cron_list(self, colony: str) -> list[dict]:
        with self._glock:
            entries = [dict(e) for e in self._crons.values() if e["colonyname"] == colony]
        entries.sort(key=lambda e: (e.get("added", 0), e["cronid"]))
        return entries

    def cron_due(self, ts: int) -> list[dict]:
        """Entries with ``deadline < ts``, earliest deadline first (the
        order of the reference's deadline heap)."""
        with self._glock:
            due = [dict(e) for e in self._crons.values() if e.get("deadline", 0) < ts]
        due.sort(key=lambda e: (e.get("deadline", 0), e["cronid"]))
        return due
