"""The Colonies server, trimmed from the reference's ``repro/core/server.py``.

A stateless broker (paper §3): every request is a signed envelope whose
signer the server recovers, checks against the colony's roles, and then
answers from the database. What it keeps of the reference:

  * process submission, long-poll assignment and close (Tables 1-2, Fig. 2)
    with the Eq. (1) priority order;
  * workflow DAGs with ``wait_for_parents`` and dynamic children (§3.4.2);
  * the ``maxexectime``/``maxwaittime`` failsafe scanner (§3.4);
  * exactly-once KEYED requests: a repeated ``(identity, msgid)`` gets the
    recorded reply, and the handler does not run again;
  * generators, cron and CFS metadata (``generator.py``, ``cron.py``,
    ``cfs.py``);
  * the HA hooks (§3.4.1): ``set_leader_check`` and ``set_op_proposer``
    make this server one replica of ``cluster.HAColonyCluster``, which
    serializes assign and close through the Raft log (a follower answers
    ``assign`` with 421 and the leader's id); the failsafe and the
    extensions' ticks run on the leader only;
  * the fault sites ``server.pre_dispatch`` and ``server.post_commit``
    (``runtime/faults.py``).

A server with no hooks set is the standalone broker: always the leader,
assign and close applied under the colony lock. The reference's
unverified in-process path is left out. Its analysis hooks are kept
(``analysis/``): the locks come from ``make_lock``, each ``_require_*``
records an auth fact inside ``handle``'s request scope, and the blocking
and state-changing internals declare ``@no_locks_held`` and
``@requires_auth``.
"""

from __future__ import annotations

import json
import logging
import secrets
import threading
import time
from typing import Any, Callable

from ..analysis import authtrack
from ..analysis.authtrack import requires_auth
from ..analysis.contracts import no_locks_held
from ..analysis.locktrack import make_lock
from ..core import blobstore, idempotency
from ..core.crypto import Crypto
from ..core.errors import (
    AuthError,
    ColoniesError,
    ConflictError,
    NotFoundError,
    NotLeaderError,
    TimeoutError_,
    ValidationError,
)
from ..core.process import (
    FAILED,
    RUNNING,
    STATES,
    SUCCESSFUL,
    WAITING,
    Process,
    new_id,
    now_ns,
)
from ..core.security import canonical
from ..core.spec import FunctionSpec, WorkflowSpec
from ..runtime import faults
from .database import Colony, Database, Executor, MemoryDatabase


def open_envelope(env: dict) -> tuple[str, str, dict[str, Any]]:
    """``(identity, payloadtype, payload)`` of a signed envelope; the
    identity is recovered from the signature over payloadtype, payload and
    msgid. Raises ``AuthError`` on a missing or broken signature."""
    ptype = env.get("payloadtype", "")
    body = env.get("payload", "")
    if isinstance(body, dict):  # pre-parsed payloads on the in-process path
        body = canonical(body)
    payload = json.loads(body) if body else {}
    sig = env.get("signature", "")
    if not sig:
        raise AuthError("missing signature")
    try:
        identity = Crypto.recover(ptype + body + env.get("msgid", ""), sig)
    except (ValueError, AssertionError) as e:
        raise AuthError(f"signature recovery failed: {e}") from e
    return identity, ptype, payload


def expand_workflow(wf: WorkflowSpec) -> list[Process]:
    """One process per node; parent/child ids wired from nodename deps."""
    workflowid = secrets.token_hex(16)
    by_name: dict[str, Process] = {}
    procs: list[Process] = []
    for spec in wf.specs:
        p = Process.create(spec)
        p.workflowid = workflowid
        by_name[spec.nodename] = p
        procs.append(p)
    for spec in wf.specs:
        p = by_name[spec.nodename]
        for dep in spec.conditions.dependencies:
            parent = by_name[dep]
            p.parents.append(parent.processid)
            parent.children.append(p.processid)
        p.wait_for_parents = len(p.parents) > 0
    return procs


class _QueueSignal:
    """Wakeup channel for one (colony, executortype) ready queue."""

    __slots__ = ("cv", "version")

    def __init__(self, key: tuple[str, str]) -> None:
        self.cv = threading.Condition(make_lock(f"queuecv:{key[0]}:{key[1]}"))
        self.version = 0


class ColoniesServer:
    """One Colonies server. ``serverid`` is the identity of the server
    owner, the only identity that may create colonies."""

    # HA replicas re-check leadership at this cadence while parked in
    # ``assign``; standalone servers sleep the full long-poll timeout and
    # rely purely on queue notifications.
    HA_LEADER_RECHECK_S = 0.5

    def __init__(self, serverid: str, db: Database | None = None,
                 name: str = "colonies-0") -> None:
        self.name = name
        self.serverid = serverid
        self.db = db if db is not None else MemoryDatabase()
        self._signals: dict[tuple[str, str], _QueueSignal] = {}
        self._signals_guard = make_lock("signals")
        # Leader-local per-colony assign serialization for the HA path (the
        # shared db.colony_lock cannot be held across a Raft proposal: the
        # commit is applied on another thread that needs that same lock).
        self._local_assign_locks: dict[str, threading.RLock] = {}
        self._handlers: dict[str, Callable[[str, dict], Any]] = {
            "addcolony": self._h_add_colony,
            "addexecutor": self._h_add_executor,
            "approveexecutor": self._h_approve_executor,
            "rejectexecutor": self._h_reject_executor,
            "removeexecutor": self._h_remove_executor,
            "listexecutors": self._h_list_executors,
            "adduser": self._h_add_user,
            "listusers": self._h_list_users,
            "addfunction": self._h_add_function,
            "listfunctions": self._h_list_functions,
            "submitfunctionspec": self._h_submit,
            "submitworkflow": self._h_submit_workflow,
            "assign": self._h_assign,
            "close": self._h_close,
            "addchild": self._h_add_child,
            "getprocess": self._h_get_process,
            "getprocesses": self._h_get_processes,
            "colonystats": self._h_stats,
        }
        self.extensions: list[Any] = []  # generator, cron and CFS handlers register here
        # HA hooks: standalone servers are always the leader. ``_propose_op``
        # serializes replicated ops (assign, close) through the Raft log;
        # every proposed entry carries a leader-stamped ``ts`` and a stable
        # ``opid`` so the apply is deterministic and replay-safe.
        self._is_leader: Callable[[], bool] = lambda: True
        self._propose_op: Callable[[dict], Any] | None = None
        self._stop = threading.Event()
        self._failsafe_thread: threading.Thread | None = None
        # exceptions swallowed (but counted) by the failsafe loop
        self.failsafe_errors = 0

    # ------------------------------------------------------------------ RPC
    def handle(self, envelope: dict, timing: dict | None = None) -> dict:
        """Entry point for all transports: ``{"result": ...}`` or
        ``{"error": ..., "status": ...}``. ``timing``, where given, receives
        the seconds the signer's recovery took (``recover``)."""
        t0 = time.perf_counter()
        try:
            identity, ptype, payload = open_envelope(envelope)
            if timing is not None:
                timing["recover"] = time.perf_counter() - t0
            # Injected server death before dispatch: the request has no
            # effect and the transport sees a dead connection. The raise
            # (FaultInjected is a ConnectionError, not a ColoniesError)
            # deliberately escapes the handlers below.
            faults.hit("server.pre_dispatch", payloadtype=ptype)
            handler = self._handlers.get(ptype)
            if handler is None:
                for ext in self.extensions:
                    handler = ext.handlers().get(ptype)
                    if handler is not None:
                        break
            if handler is None:
                raise ValidationError(f"unknown payloadtype {ptype!r}")
            # A KEYED envelope whose (identity, msgid) has a recorded reply
            # is a client retry of a committed operation: replay the reply.
            # The msgid is covered by the signature, so only its signer can.
            msgid = str(envelope.get("msgid") or "")
            dedup_key = ""
            if msgid and idempotency.classify(ptype) == idempotency.KEYED:
                dedup_key = f"{identity}:{msgid}"
                cached = self.db.dedup_get(dedup_key)
                if cached is not None:
                    return {"result": cached, "replayed": True}
            # Under REPRO_AUTH_CHECK=1 the scope arms the database guards:
            # colony-scoped access inside this dispatch requires a recorded
            # auth fact (see analysis/authtrack.py).
            token = idempotency.set_current(msgid)
            try:
                with authtrack.request_scope():
                    result = handler(identity, payload)
            finally:
                idempotency.reset_current(token)
            # successes only: a handler raises before it mutates anything;
            # the colony bounds the record's table share
            if dedup_key:
                self.db.dedup_put(dedup_key, idempotency.reply_colony(ptype, payload, result),
                                  now_ns(), result)
            # The crash-after-commit-before-reply window: effect and dedup
            # record are stored, the reply is lost.
            faults.hit("server.post_commit", payloadtype=ptype)
            return {"result": result}
        except NotLeaderError as e:
            return {"error": str(e), "status": e.status, "leader": e.leader}
        except ColoniesError as e:
            return {"error": str(e), "status": e.status}

    # ------------------------------------------------------------ auth utils
    # Each check records its verified (identity, colony, role) as an auth
    # fact for the current request (a no-op unless REPRO_AUTH_CHECK=1);
    # colony-scoped database access without a matching fact then raises.
    def _require_server_owner(self, identity: str) -> None:
        if identity != self.serverid:
            raise AuthError("requires server owner")
        authtrack.record(identity, authtrack.ANY_COLONY, "server")

    def _require_colony_owner(self, identity: str, colonyname: str) -> Colony:
        colony = self.db.get_colony(colonyname)
        if identity != colony.colonyid:
            raise AuthError("requires colony owner")
        authtrack.record(identity, colonyname, "owner")
        return colony

    def _require_member(self, identity: str, colonyname: str) -> Executor | None:
        """Approved executor OR registered user OR colony owner."""
        colony = self.db.get_colony(colonyname)
        if identity == colony.colonyid:
            authtrack.record(identity, colonyname, "owner")
            return None
        try:
            ex = self.db.get_executor(identity)
            if ex.colonyname == colonyname and ex.state == "approved":
                authtrack.record(identity, colonyname, "executor")
                self.db.touch_executor(identity, now_ns())
                return ex
        except NotFoundError:
            pass
        user = self.db.user_get(identity)
        if user is not None and user.get("colonyname") == colonyname:
            authtrack.record(identity, colonyname, "member")
            return None
        raise AuthError("identity is not a member of the colony")

    def _require_executor(self, identity: str, colonyname: str) -> Executor:
        try:
            ex = self.db.get_executor(identity)
        except NotFoundError as e:
            raise AuthError("unknown executor identity") from e
        if ex.colonyname != colonyname:
            raise AuthError("executor belongs to another colony")
        if ex.state != "approved":
            raise AuthError(f"executor not approved (state={ex.state})")
        authtrack.record(identity, colonyname, "executor")
        self.db.touch_executor(identity, now_ns())
        return ex

    # -------------------------------------------------------------- handlers
    def _h_add_colony(self, identity: str, payload: dict) -> dict:
        self._require_server_owner(identity)
        colony = Colony.from_dict(payload.get("colony", payload))
        if not colony.colonyname or not colony.colonyid:
            raise ValidationError("colony needs colonyname and colonyid")
        self.db.add_colony(colony)
        return colony.to_dict()

    def _h_add_executor(self, identity: str, payload: dict) -> dict:
        ex = Executor.from_dict(payload.get("executor", payload))
        self._require_colony_owner(identity, ex.colonyname)
        if not ex.executorid or not ex.executortype:
            raise ValidationError("executor needs executorid and executortype")
        ex.state = "pending"
        ex.commissiontime_ns = now_ns()
        self.db.add_executor(ex)
        return ex.to_dict()

    def _h_approve_executor(self, identity: str, payload: dict) -> dict:
        ex = self.db.get_executor(payload["executorid"])
        self._require_colony_owner(identity, ex.colonyname)
        self.db.set_executor_state(ex.executorid, "approved")
        return {"executorid": ex.executorid, "state": "approved"}

    def _h_reject_executor(self, identity: str, payload: dict) -> dict:
        ex = self.db.get_executor(payload["executorid"])
        self._require_colony_owner(identity, ex.colonyname)
        self.db.set_executor_state(ex.executorid, "rejected")
        return {"executorid": ex.executorid, "state": "rejected"}

    def _h_remove_executor(self, identity: str, payload: dict) -> dict:
        ex = self.db.get_executor(payload["executorid"])
        self._require_colony_owner(identity, ex.colonyname)
        self.db.remove_executor(ex.executorid)
        return {"executorid": ex.executorid, "removed": True}

    def _h_list_executors(self, identity: str, payload: dict) -> list[dict]:
        colony = payload["colonyname"]
        self._require_member(identity, colony)
        return [e.to_dict() for e in self.db.list_executors(colony)]

    def _h_add_user(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        self._require_colony_owner(identity, colony)
        user = {"userid": payload["userid"], "username": payload.get("username", ""),
                "colonyname": colony}
        self.db.user_put(user)
        return user

    def _h_list_users(self, identity: str, payload: dict) -> list[dict]:
        colony = payload["colonyname"]
        self._require_member(identity, colony)
        return self.db.user_list(colony)

    def _h_add_function(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        ex = self._require_executor(identity, colony)
        self.db.add_function(ex.executorid, colony, payload["funcname"])
        return {"executorid": ex.executorid, "funcname": payload["funcname"]}

    def _h_list_functions(self, identity: str, payload: dict) -> list[dict]:
        colony = payload["colonyname"]
        self._require_member(identity, colony)
        return self.db.list_functions(colony, payload.get("executorid"))

    # -- submit -------------------------------------------------------------
    def _h_submit(self, identity: str, payload: dict) -> dict:
        spec = FunctionSpec.from_dict(payload.get("spec", payload))
        if not spec.conditions.colonyname:
            raise ValidationError("spec.conditions.colonyname required")
        if not spec.conditions.executortype:
            raise ValidationError("spec.conditions.executortype required")
        self._require_member(identity, spec.conditions.colonyname)
        p = Process.create(spec)
        self.db.add_process(p)
        self._notify_queue([self._queue_key(p)])
        return p.to_dict()

    def _h_submit_workflow(self, identity: str, payload: dict) -> dict:
        wf = WorkflowSpec.from_dict(payload.get("workflow", payload))
        colony = wf.colonyname or (wf.specs[0].conditions.colonyname if wf.specs else "")
        if not colony:
            raise ValidationError("workflow needs a colonyname")
        self._require_member(identity, colony)
        if not wf.specs:
            raise ValidationError("empty workflow")
        for s in wf.specs:
            s.conditions.colonyname = s.conditions.colonyname or colony
        wf.validate()
        procs = self.submit_workflow_processes(wf)
        self._notify_queue([self._queue_key(p) for p in procs if not p.wait_for_parents])
        return {"workflowid": procs[0].workflowid, "processes": [p.to_dict() for p in procs]}

    @requires_auth("member")
    def submit_workflow_processes(self, wf: WorkflowSpec) -> list[Process]:
        """DAG expansion (paper §3.4.2): one process per node, linked by ids."""
        procs = expand_workflow(wf)
        for p in procs:
            self.db.add_process(p)
        return procs

    # -- assign ---------------------------------------------------------------
    def _h_assign(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        timeout = float(payload.get("timeout", 10.0))
        ex = self._require_executor(identity, colony)
        p = self.assign(colony, ex, timeout)
        if p is None:
            raise TimeoutError_("no process assigned within timeout")
        return p.to_dict()

    @no_locks_held()
    def assign(self, colony: str, ex: Executor, timeout: float) -> Process | None:
        """Long-poll assignment (paper §3.3: the server *hangs* the request):
        the request parks on its (colony, executortype) signal and is woken
        when that queue gains work. An HA replica answers ``NotLeaderError``
        unless it leads, and re-checks that every ``HA_LEADER_RECHECK_S``
        while it waits."""
        deadline = now_ns() + int(timeout * 1e9)
        sig = self._signal((colony, ex.executortype))
        while not self._stop.is_set():
            if not self._is_leader():
                raise NotLeaderError("assign must be served by the leader")
            with sig.cv:
                version = sig.version
            p = self._try_assign_once(colony, ex)
            if p is not None:
                return p
            remaining = (deadline - now_ns()) / 1e9
            if remaining <= 0:
                return None
            # HA replicas wake periodically to notice lost leadership;
            # standalone servers sleep until notified (or timeout).
            tick = self.HA_LEADER_RECHECK_S if self._propose_op is not None else remaining
            with sig.cv:
                if sig.version == version:  # nothing arrived since the probe
                    sig.cv.wait(timeout=min(remaining, tick))
        return None

    def _local_assign_lock(self, colony: str) -> threading.RLock:
        with self._signals_guard:
            lk = self._local_assign_locks.get(colony)
            if lk is None:
                lk = self._local_assign_locks[colony] = make_lock(f"assignlocal:{colony}")
            return lk

    def _try_assign_once(self, colony: str, ex: Executor) -> Process | None:
        if self._propose_op is not None:
            # HA: leader-local serialization; Raft log order plus the
            # WAITING CAS in apply_assign make assignment exactly-once.
            lock = self._local_assign_lock(colony)
        else:
            lock = self.db.colony_lock(colony)
        with lock:
            for p in self.db.candidates(colony, ex.executortype, ex.executorname):
                # Leader-stamped entry: the wall clock and the op identity
                # are fixed here, before the Raft log, so the apply is
                # deterministic on every replica.
                op = {
                    "op": "assign",
                    "opid": new_id(),
                    "processid": p.processid,
                    "executorid": ex.executorid,
                    "ts": now_ns(),
                    # the request's idempotency key rides the Raft entry
                    # ("" for unkeyed callers)
                    "msgid": idempotency.current(),
                }
                if self._propose_op is not None:
                    # HA path: serialize through the Raft log, then confirm
                    # this op won the apply's WAITING CAS (a failsafe expiry
                    # or leader churn may have beaten it; the cluster
                    # swallows that conflict).
                    self._propose_op(op)
                    assigned = self.db.get_process(p.processid)
                    if assigned.state != RUNNING or assigned.assignedexecutorid != ex.executorid:
                        continue  # lost the race: try the next candidate
                    return assigned
                self.apply_assign(op)
                return self.db.get_process(p.processid)
        return None

    @requires_auth("executor")
    def apply_assign(self, op: dict) -> None:
        """State-machine apply of an assign op (also run by the Raft commit):
        a compare-and-swap on ``state == WAITING`` under the colony lock,
        so a replay after a failover, or a failsafe reset racing the
        assignment, raises ``ConflictError`` instead of mutating twice."""
        p = self.db.get_process(op["processid"])
        with self.db.colony_lock(p.colonyname):
            p = self.db.get_process(op["processid"])  # re-read under the lock
            if p.state != WAITING:
                raise ConflictError("process no longer waiting")
            ts = op["ts"]
            p.state = RUNNING
            p.isassigned = True
            p.assignedexecutorid = op["executorid"]
            p.starttime_ns = ts
            maxexec = p.spec.maxexectime
            p.deadline_ns = ts + maxexec * 10**9 if maxexec and maxexec > 0 else 0
            # Dataflow (Table 4): inputs = concatenated parent outputs.
            if p.parents:
                p.inputs = [x for pid in p.parents for x in self.db.get_process(pid).output]
            self.db.update_process(p)

    # -- close ---------------------------------------------------------------
    def _h_close(self, identity: str, payload: dict) -> dict:
        pid = payload["processid"]
        p = self.db.get_process(pid)
        ex = self._require_executor(identity, p.colonyname)
        if p.assignedexecutorid != ex.executorid or p.state != RUNNING:
            # e.g. the failsafe already reset this process (paper §4.1:
            # "The previous executor then receives an error").
            raise ConflictError("process is not assigned to this executor")
        # Leader-stamped entry: the end time is fixed before the Raft log,
        # so close replays identically on every replica.
        op = {
            "op": "close",
            "opid": new_id(),
            "processid": pid,
            "executorid": ex.executorid,
            "successful": bool(payload.get("successful", True)),
            "out": payload.get("out", []),
            "errors": payload.get("errors", []),
            "ts": now_ns(),
            "msgid": idempotency.current(),
        }
        if self._propose_op is not None:
            # HA path: serialize close through the Raft log, then confirm
            # this close won the apply's RUNNING + owner CAS by its
            # leader-stamped end time.
            self._propose_op(op)
            closed = self.db.get_process(pid)
            if closed.state not in (SUCCESSFUL, FAILED) or closed.endtime_ns != op["ts"]:
                raise ConflictError("process is not assigned to this executor")
        else:
            self.apply_close(op)
        return self.db.get_process(pid).to_dict()

    @requires_auth("executor")
    def apply_close(self, op: dict) -> None:
        """State-machine apply of a close op (also run by the Raft commit):
        the wall clock arrives leader-stamped as ``op["ts"]``, and the
        RUNNING + owner CAS of ``close_process`` turns a replay into a
        ``ConflictError`` instead of a second mutation."""
        p = self.db.get_process(op["processid"])
        self.close_process(p, bool(op.get("successful", True)), op.get("out", []),
                           op.get("errors", []), op["executorid"], ts=op["ts"])

    @requires_auth("executor")
    def close_process(self, p: Process, succeeded: bool, output: list[Any], errors: list[str],
                      expected_executorid: str, *, ts: int) -> None:
        """Close and propagate through the DAG (paper §3.4.2). The process
        is re-checked under the colony lock (still RUNNING, still owned by
        ``expected_executorid``), so a failsafe reset in between turns this
        into a ``ConflictError``."""
        released: list[tuple[str, str]] = []
        with self.db.colony_lock(p.colonyname):
            fresh = self.db.get_process(p.processid)
            if fresh.state != RUNNING:
                raise ConflictError("process is not running")
            if fresh.assignedexecutorid != expected_executorid:
                raise ConflictError("process is not assigned to this executor")
            fresh.state = SUCCESSFUL if succeeded else FAILED
            fresh.endtime_ns = ts
            fresh.output = list(output)
            fresh.errors = list(errors)
            fresh.deadline_ns = 0
            self.db.update_process(fresh)
            if succeeded:
                for child_id in fresh.children:
                    child = self._maybe_release_child(child_id)
                    if child is not None:
                        released.append(self._queue_key(child))
            else:
                # fail the descendants, so that the workflow ends
                self._fail_descendants(fresh, f"parent process {fresh.processid} failed", ts)
        if released:
            self._notify_queue(released)

    def _maybe_release_child(self, child_id: str) -> Process | None:
        child = self.db.get_process(child_id)
        if not child.wait_for_parents:
            return None
        if any(self.db.get_process(pid).state != SUCCESSFUL for pid in child.parents):
            return None
        child.wait_for_parents = False
        self.db.update_process(child)
        self.db.requeue(child)
        return child

    def _fail_descendants(self, p: Process, reason: str, ts: int) -> None:
        for child_id in p.children:
            child = self.db.get_process(child_id)
            if child.state in (WAITING, RUNNING):
                child.state = FAILED
                child.endtime_ns = ts
                child.errors = [reason]
                self.db.update_process(child)
                self._fail_descendants(child, reason, ts)

    # -- dynamic children (MapReduce on the fly, paper §3.4.2) ----------------
    def _h_add_child(self, identity: str, payload: dict) -> dict:
        parent_id = payload["processid"]
        parent = self.db.get_process(parent_id)
        ex = self._require_executor(identity, parent.colonyname)
        if parent.assignedexecutorid != ex.executorid or parent.state != RUNNING:
            raise AuthError("only the assigned executor may extend the DAG")
        spec = FunctionSpec.from_dict(payload["spec"])
        spec.conditions.colonyname = parent.colonyname
        child = Process.create(spec)
        with self.db.colony_lock(parent.colonyname):
            parent = self.db.get_process(parent_id)  # re-read under the lock
            if parent.assignedexecutorid != ex.executorid or parent.state != RUNNING:
                raise ConflictError("parent closed or reassigned while extending the DAG")
            child.workflowid = parent.workflowid
            if payload.get("waitforparent", False):
                child.parents = [parent_id]
                child.wait_for_parents = True
            self.db.add_process(child)
            parent.children = parent.children + [child.processid]
            self.db.update_process(parent)
        if not child.wait_for_parents:
            self._notify_queue([self._queue_key(child)])
        return child.to_dict()

    # -- introspection ---------------------------------------------------------
    def _h_get_process(self, identity: str, payload: dict) -> dict:
        p = self.db.get_process(payload["processid"])
        self._require_member(identity, p.colonyname)
        return p.to_dict()

    def _h_get_processes(self, identity: str, payload: dict) -> list[dict]:
        colony = payload["colonyname"]
        self._require_member(identity, colony)
        return [p.to_dict() for p in self.db.list_processes(
            colony, payload.get("state"), int(payload.get("count", 100)))]

    def _h_stats(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        self._require_member(identity, colony)
        stats: dict[str, int] = {s: 0 for s in STATES}
        stats.update(self.db.colony_stats(colony))
        stats["executors"] = len(self.db.list_executors(colony))
        stats["failsafe_errors"] = self.failsafe_errors
        # Blob-plane counters over every live ShardedStorage of this
        # process: the broker process of an HTTP deployment holds none.
        stats["blob"] = blobstore.aggregate_stats()
        return stats

    # -- failsafe (paper §3.4) --------------------------------------------------
    @no_locks_held()
    def failsafe_scan(self) -> dict:
        """One failsafe pass. A running process past its ``maxexectime``
        goes back to the queue with ``retries + 1`` (or fails once its
        retries are spent); a waiting one past its ``maxwaittime`` fails.
        The deadline indexes hand back what had expired when they were
        read, possibly as copies: each process is re-read under its
        colony lock and re-checked before it changes, and one that has
        gone since is skipped."""
        ts = now_ns()
        reset = failed = expired = 0
        woken: list[tuple[str, str]] = []
        for p in self.db.running_past_deadline(ts):
            with self.db.colony_lock(p.colonyname):
                try:
                    cur = self.db.get_process(p.processid)
                except NotFoundError:
                    continue
                if cur.state != RUNNING or not cur.deadline_ns or cur.deadline_ns >= ts:
                    continue  # closed or re-assigned since the index read
                if cur.retries + 1 > max(cur.spec.maxretries, 0):
                    cur.state = FAILED
                    cur.endtime_ns = ts
                    cur.errors = cur.errors + ["maxretries exceeded after maxexectime reset"]
                    self.db.update_process(cur)
                    self._fail_descendants(cur, f"parent process {cur.processid} failed", ts)
                    failed += 1
                else:
                    cur.state = WAITING
                    cur.isassigned = False
                    cur.assignedexecutorid = ""
                    cur.starttime_ns = 0
                    cur.deadline_ns = 0
                    cur.retries += 1
                    self.db.update_process(cur)
                    self.db.requeue(cur)
                    woken.append(self._queue_key(cur))
                    reset += 1
        for p in self.db.waiting_past_deadline(ts):
            with self.db.colony_lock(p.colonyname):
                try:
                    cur = self.db.get_process(p.processid)
                except NotFoundError:
                    continue
                if cur.state != WAITING or not cur.waitdeadline_ns or cur.waitdeadline_ns >= ts:
                    continue
                cur.state = FAILED
                cur.endtime_ns = ts
                cur.errors = cur.errors + ["maxwaittime exceeded"]
                self.db.update_process(cur)
                self._fail_descendants(cur, f"parent process {cur.processid} failed", ts)
                expired += 1
        if woken:
            self._notify_queue(woken)
        return {"reset": reset, "failed": failed, "waitexpired": expired}

    def start_background(self, failsafe_interval: float = 0.25) -> None:
        """Run the failsafe scan and the extensions' ticks every
        ``failsafe_interval`` seconds, on the leader only. The loop survives
        anything a scan throws: failures are counted (``colonystats``'
        ``failsafe_errors``) and the first is logged."""

        def loop() -> None:
            while not self._stop.wait(failsafe_interval):
                try:
                    if self._is_leader():
                        self.failsafe_scan()
                    for ext in self.extensions:
                        tick = getattr(ext, "tick", None)
                        if tick is not None and self._is_leader():
                            tick()
                except Exception:
                    if self.failsafe_errors == 0:
                        logging.getLogger(__name__).exception("failsafe loop error")
                    self.failsafe_errors += 1

        self._failsafe_thread = threading.Thread(target=loop, daemon=True)
        self._failsafe_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._notify_queue()
        if self._failsafe_thread is not None:
            self._failsafe_thread.join(timeout=2)

    # -- queue wakeups -------------------------------------------------------
    @staticmethod
    def _queue_key(p: Process) -> tuple[str, str]:
        return (p.colonyname, p.spec.conditions.executortype)

    def _signal(self, key: tuple[str, str]) -> _QueueSignal:
        with self._signals_guard:
            sig = self._signals.get(key)
            if sig is None:
                sig = self._signals[key] = _QueueSignal(key)
            return sig

    def _notify_queue(self, keys: list[tuple[str, str]] | None = None) -> None:
        """Wake long-poll waiters. ``keys=None`` (generators, stop) wakes all."""
        if keys is None:
            with self._signals_guard:
                sigs = list(self._signals.values())
        else:
            sigs = [self._signal(k) for k in set(keys)]
        for sig in sigs:
            with sig.cv:
                sig.version += 1
                sig.cv.notify_all()

    # -- HA wiring ---------------------------------------------------------------
    def set_leader_check(self, fn: Callable[[], bool]) -> None:
        self._is_leader = fn

    def set_op_proposer(self, fn: Callable[[dict], Any]) -> None:
        """Route replicated ops (assign, close) through the Raft log. The
        callable must block until the entry is committed and applied
        locally (``ThreadedRaftCluster.propose_and_wait``)."""
        self._propose_op = fn
