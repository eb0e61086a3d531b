"""Colonies client SDK (paper §4.1, Listings 3–5).

A copy of the reference's ``repro/core/client.py``, with its client-side
fault sites (``transport.send``, ``transport.recv``; see
``runtime/faults.py``): with no plan installed each is one global read.
A fault injected at the broker reaches this client as a lost connection,
which it retries as the reference does.

Transport-agnostic: ``InProcTransport`` calls a server object directly
(deterministic tests), ``HttpTransport`` speaks the JSON envelope protocol
over HTTP with long-polling ``assign`` (see http_transport.py). The SDK
surface mirrors the paper's Python SDK (``pycolonies``).
"""

from __future__ import annotations

import time
from typing import Any

from .. import trace
from ..runtime import faults
from . import idempotency
from .errors import (
    AuthError,
    ColoniesError,
    ConflictError,
    NotFoundError,
    NotLeaderError,
    TimeoutError_,
    TransportError,
    ValidationError,
)
from .process import new_id
from .retry import RetryPolicy, send_with_retry
from .security import sign_envelope
from .spec import FunctionSpec, WorkflowSpec

_ERROR_TYPES: dict[int, type[ColoniesError]] = {
    400: ValidationError,
    403: AuthError,
    404: NotFoundError,
    408: TimeoutError_,
    409: ConflictError,
    421: NotLeaderError,
    503: TransportError,
}


class InProcTransport:
    """Direct dispatch to one or more server replicas (follower redirect aware).

    ``retry=RetryPolicy(...)`` re-runs the replica pass on transport-level
    failures (503/421) with capped jittered backoff — see retry.py."""

    def __init__(self, servers: list, retry: RetryPolicy | None = None) -> None:
        if not isinstance(servers, list):
            servers = [servers]
        self.servers = servers
        self.retry = retry
        self._preferred = 0

    def send(self, envelope: dict, timeout: float | None = None) -> dict:
        # timeout is accepted for interface parity with HttpTransport;
        # in-proc dispatch blocks in the server's own long-poll budget.
        return send_with_retry(lambda: self._send_once(envelope), self.retry)

    def _send_once(self, envelope: dict) -> dict:
        ptype = envelope.get("payloadtype", "")
        last: dict = {"error": "no servers", "status": 500}
        order = list(range(len(self.servers)))
        order = order[self._preferred :] + order[: self._preferred]
        for idx in order:
            try:
                action = faults.hit("transport.send", payloadtype=ptype)
                resp = self.servers[idx].handle(envelope)
                if action == "duplicate":  # at-least-once delivery: send twice
                    resp = self.servers[idx].handle(envelope)
                faults.hit("transport.recv", payloadtype=ptype)
            except ConnectionError as e:
                # Injected transport faults and server-side crash windows
                # (FaultInjected is a ConnectionError) look identical to a
                # dead connection: retryable, reply lost.
                last = {"error": f"transport: {e}", "status": 503}
                continue
            if resp.get("status") == 421:  # not leader — try the next replica
                last = resp
                continue
            self._preferred = idx
            return resp
        return last


class Colonies:
    """The SDK client: ``Colonies(transport)`` or ``Colonies.connect(host, port)``.

    Every request is signed, and every KEYED one carries a msgid. The
    reference's two broker-benchmark switches (``insecure``, unsigned
    requests; ``idempotency=False``, unkeyed ones) are not copied."""

    def __init__(self, transport) -> None:
        self.transport = transport

    @staticmethod
    def connect(host: str, port: int, retry: RetryPolicy | None = None) -> "Colonies":
        from .http_transport import HttpTransport

        return Colonies(HttpTransport(host, port, retry=retry))

    # ------------------------------------------------------------------ rpc
    def _rpc(
        self,
        payloadtype: str,
        payload: dict,
        prvkey: str,
        timeout: float | None = None,
        msgid: str | None = None,
    ) -> Any:
        if msgid is None and idempotency.classify(payloadtype) == idempotency.KEYED:
            # One key per logical operation: transport retries of this
            # call all carry the same msgid, so the server dedups them.
            msgid = new_id()
        # the round trip, the signature inside it; an HTTP transport adds
        # the broker's own share, read from the reply
        with trace.span(f"rpc.{payloadtype}"):
            with trace.span("rpc.sign"):
                env = sign_envelope(payloadtype, payload, prvkey, msgid=msgid)
            if timeout is None:
                resp = self.transport.send(env)
            else:
                resp = self.transport.send(env, timeout=timeout)
        if "error" in resp:
            err_cls = _ERROR_TYPES.get(int(resp.get("status", 500)), ColoniesError)
            raise err_cls(resp["error"])
        return resp["result"]

    # ------------------------------------------------------------- colonies
    def add_colony(self, colonyname: str, colonyid: str, server_prvkey: str) -> dict:
        return self._rpc(
            "addcolony",
            {"colony": {"colonyname": colonyname, "colonyid": colonyid}},
            server_prvkey,
        )

    # ------------------------------------------------------------- executors
    def add_executor(self, executor: dict, colony_prvkey: str) -> dict:
        return self._rpc("addexecutor", {"executor": executor}, colony_prvkey)

    def approve_executor(self, executorid: str, colony_prvkey: str) -> dict:
        return self._rpc("approveexecutor", {"executorid": executorid}, colony_prvkey)

    def reject_executor(self, executorid: str, colony_prvkey: str) -> dict:
        return self._rpc("rejectexecutor", {"executorid": executorid}, colony_prvkey)

    def remove_executor(self, executorid: str, colony_prvkey: str) -> dict:
        return self._rpc("removeexecutor", {"executorid": executorid}, colony_prvkey)

    def list_executors(self, colonyname: str, prvkey: str) -> list[dict]:
        return self._rpc("listexecutors", {"colonyname": colonyname}, prvkey)

    def add_user(self, colonyname: str, userid: str, username: str, colony_prvkey: str) -> dict:
        return self._rpc(
            "adduser",
            {"colonyname": colonyname, "userid": userid, "username": username},
            colony_prvkey,
        )

    def list_users(self, colonyname: str, prvkey: str) -> list[dict]:
        return self._rpc("listusers", {"colonyname": colonyname}, prvkey)

    def add_function(
        self, executorid: str, colonyname: str, funcname: str, executor_prvkey: str
    ) -> dict:
        return self._rpc(
            "addfunction",
            {"executorid": executorid, "colonyname": colonyname, "funcname": funcname},
            executor_prvkey,
        )

    # ------------------------------------------------------------- processes
    def submit(self, spec: FunctionSpec | dict, prvkey: str) -> dict:
        spec_d = spec.to_dict() if isinstance(spec, FunctionSpec) else spec
        return self._rpc("submitfunctionspec", {"spec": spec_d}, prvkey)

    def submit_workflow(self, wf: WorkflowSpec | dict, prvkey: str) -> dict:
        wf_d = wf.to_dict() if isinstance(wf, WorkflowSpec) else wf
        return self._rpc("submitworkflow", {"workflow": wf_d}, prvkey)

    def assign(self, colonyname: str, timeout: float, executor_prvkey: str) -> dict:
        """Long-poll for a process assignment (raises TimeoutError_ on expiry)."""
        return self._rpc(
            "assign", {"colonyname": colonyname, "timeout": timeout}, executor_prvkey
        )

    def close(
        self,
        processid: str,
        output: list[Any],
        executor_prvkey: str,
        msgid: str | None = None,
    ) -> dict:
        # msgid lets a caller (the executor's pending-close journal) reuse
        # one idempotency key across its own re-deliveries of this close.
        return self._rpc(
            "close",
            {"processid": processid, "successful": True, "out": list(output)},
            executor_prvkey,
            msgid=msgid,
        )

    def fail(
        self,
        processid: str,
        errors: list[str],
        executor_prvkey: str,
        msgid: str | None = None,
    ) -> dict:
        return self._rpc(
            "close",
            {"processid": processid, "successful": False, "errors": list(errors)},
            executor_prvkey,
            msgid=msgid,
        )

    def add_child(
        self,
        processid: str,
        spec: FunctionSpec | dict,
        executor_prvkey: str,
        waitforparent: bool = False,
    ) -> dict:
        spec_d = spec.to_dict() if isinstance(spec, FunctionSpec) else spec
        return self._rpc(
            "addchild",
            {"processid": processid, "spec": spec_d, "waitforparent": waitforparent},
            executor_prvkey,
        )

    def get_process(self, processid: str, prvkey: str) -> dict:
        return self._rpc("getprocess", {"processid": processid}, prvkey)

    def get_processes(
        self, colonyname: str, prvkey: str, state: str | None = None, count: int = 100
    ) -> list[dict]:
        return self._rpc(
            "getprocesses",
            {"colonyname": colonyname, "state": state, "count": count},
            prvkey,
        )

    def stats(self, colonyname: str, prvkey: str) -> dict:
        return self._rpc("colonystats", {"colonyname": colonyname}, prvkey)

    def wait(
        self, processid: str, prvkey: str, timeout: float = 30.0, poll: float = 0.05
    ) -> dict:
        """Poll until a process reaches a terminal state.

        The overall deadline holds even against a hung transport: each
        poll gets a per-request timeout derived from the remaining
        budget, and the timeout error surfaces the last non-timeout
        failure instead of a generic message."""
        deadline = time.monotonic() + timeout
        last_err: ColoniesError | None = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                p = self._rpc(
                    "getprocess",
                    {"processid": processid},
                    prvkey,
                    timeout=max(0.05, remaining),
                )
                if p["state"] in ("successful", "failed"):
                    return p
            except TimeoutError_:
                pass  # transient poll expiry; the outer deadline governs
            except ColoniesError as e:
                last_err = e
            time.sleep(max(0.0, min(poll, deadline - time.monotonic())))
        detail = f" (last error: {last_err})" if last_err is not None else ""
        raise TimeoutError_(
            f"process {processid} still not terminal after {timeout}s{detail}"
        )

    # ------------------------------------------------------------------ cron
    def add_cron(self, cron: dict, prvkey: str) -> dict:
        return self._rpc("addcron", {"cron": cron}, prvkey)

    def get_crons(self, colonyname: str, prvkey: str) -> list[dict]:
        return self._rpc("getcrons", {"colonyname": colonyname}, prvkey)

    def remove_cron(self, cronid: str, prvkey: str) -> dict:
        return self._rpc("removecron", {"cronid": cronid}, prvkey)

    # -------------------------------------------------------------- generator
    def add_generator(self, generator: dict, prvkey: str) -> dict:
        return self._rpc("addgenerator", {"generator": generator}, prvkey)

    def pack(self, generatorid: str, arg: Any, prvkey: str) -> dict:
        return self._rpc("pack", {"generatorid": generatorid, "arg": arg}, prvkey)

    def get_generators(self, colonyname: str, prvkey: str) -> list[dict]:
        return self._rpc("getgenerators", {"colonyname": colonyname}, prvkey)

    # -------------------------------------------------------------------- cfs
    def add_file(self, file: dict, prvkey: str) -> dict:
        return self._rpc("addfile", {"file": file}, prvkey)

    def get_file(self, colonyname: str, label: str, name: str, prvkey: str) -> dict:
        return self._rpc(
            "getfile",
            {"colonyname": colonyname, "label": label, "name": name},
            prvkey,
        )

    def get_files(self, colonyname: str, label: str, prvkey: str) -> list[dict]:
        return self._rpc("getfiles", {"colonyname": colonyname, "label": label}, prvkey)

    def remove_file(self, colonyname: str, fileid: str, prvkey: str) -> dict:
        return self._rpc(
            "removefile", {"colonyname": colonyname, "fileid": fileid}, prvkey
        )

    def create_snapshot(self, colonyname: str, label: str, name: str, prvkey: str) -> dict:
        return self._rpc(
            "createsnapshot",
            {"colonyname": colonyname, "label": label, "name": name},
            prvkey,
        )

    def get_snapshot(self, colonyname: str, snapshotid: str, prvkey: str) -> dict:
        return self._rpc(
            "getsnapshot", {"colonyname": colonyname, "snapshotid": snapshotid}, prvkey
        )

    def get_snapshots(self, colonyname: str, prvkey: str) -> list[dict]:
        return self._rpc("getsnapshots", {"colonyname": colonyname}, prvkey)

    def remove_snapshot(self, colonyname: str, snapshotid: str, prvkey: str) -> dict:
        return self._rpc(
            "removesnapshot",
            {"colonyname": colonyname, "snapshotid": snapshotid},
            prvkey,
        )
