"""Executor microservice base (paper §3.1, §4.1 Listings 3–4).

A copy of the reference's ``repro/core/executor.py``, with the spans
``executor.assign`` (the long poll) and ``executor.close`` (``trace.py``).

An executor is a small, independently deployable service that:
  1. generates an identity and is registered+approved by the colony owner,
  2. announces the functions it can run,
  3. long-polls ``assign`` and dispatches to registered handlers,
  4. closes processes with output (or failure), optionally extending the
     DAG with dynamic children.

Function handlers receive ``(ctx, *args, **kwargs)`` where ``ctx`` exposes
the process, the SDK client and CFS sync helpers.
"""

from __future__ import annotations

import os
import random
import threading
import time
import traceback
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

from .. import trace
from .client import Colonies
from .crypto import Crypto
from .errors import (
    ColoniesError,
    ConflictError,
    NotLeaderError,
    TimeoutError_,
    TransportError,
)
from .process import Process, new_id

# Pending-close journal bounds: per-result delivery attempts before the
# result is declared lost, and the capped base backoff between attempts.
PENDING_MAX_ATTEMPTS = 8
PENDING_BACKOFF_BASE_S = 0.05
PENDING_BACKOFF_CAP_S = 2.0


@dataclass
class _PendingClose:
    """A computed result whose delivery to the broker failed retryably.

    The msgid is fixed at creation and reused on every re-delivery, so
    the server's dedup table collapses them into one close even when an
    earlier attempt committed but lost its reply (ROBUSTNESS.md)."""

    processid: str
    successful: bool
    out: list
    errors: list
    msgid: str
    counted: bool  # outcome already reflected in processed/failed
    attempts: int = 0
    next_try: float = 0.0


@dataclass
class ProcessContext:
    process: Process
    client: Colonies
    executor: "ExecutorBase"
    workdir: str = ""
    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def inputs(self) -> list[Any]:
        return self.process.inputs

    def add_child(self, spec: dict, waitforparent: bool = False) -> dict:
        return self.client.add_child(
            self.process.processid, spec, self.executor.prvkey, waitforparent
        )


class ExecutorBase:
    """Long-poll worker; subclass or register function handlers directly."""

    def __init__(
        self,
        client: Colonies,
        colonyname: str,
        executorname: str,
        executortype: str,
        colony_prvkey: str | None = None,
        prvkey: str | None = None,
        capabilities: dict[str, Any] | None = None,
        workdir_root: str | None = None,
    ) -> None:
        self.client = client
        self.colonyname = colonyname
        self.executorname = executorname
        self.executortype = executortype
        # When set, every assigned process gets its own directory under
        # this root (ctx.workdir) — the sandbox the CFS sync directives
        # (fs.snapshots / fs.dirs) materialize into and upload from.
        self.workdir_root = workdir_root
        self.prvkey = prvkey or Crypto.prvkey()
        self.executorid = Crypto.id(self.prvkey)
        self.capabilities = capabilities or {}
        self._handlers: dict[str, Callable[..., Any]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.processed = 0
        self.failed = 0
        # Pending-close journal: computed results whose delivery failed
        # retryably wait here for flush_pending_closes instead of being
        # dropped. The lock guards only list swaps — never held across RPC.
        self._pending: list[_PendingClose] = []
        self._pending_lock = threading.Lock()
        # Deterministic per-executor jitter (tests may override _rng).
        self._rng = random.Random(zlib.crc32(self.executorid.encode()))
        if colony_prvkey is not None:
            self.register(colony_prvkey)

    # ------------------------------------------------------------ lifecycle
    def register(self, colony_prvkey: str) -> None:
        self.client.add_executor(
            {
                "executorname": self.executorname,
                "executorid": self.executorid,
                "colonyname": self.colonyname,
                "executortype": self.executortype,
                "capabilities": self.capabilities,
            },
            colony_prvkey,
        )
        self.client.approve_executor(self.executorid, colony_prvkey)

    def register_function(self, funcname: str, fn: Callable[..., Any]) -> None:
        self._handlers[funcname] = fn
        self.client.add_function(self.executorid, self.colonyname, funcname, self.prvkey)

    # ------------------------------------------------------------ main loop
    def step(self, timeout: float = 1.0) -> bool:
        """One assign+execute+close cycle; returns True if a process ran."""
        try:
            with trace.span("executor.assign"):  # the long poll
                pd = self.client.assign(self.colonyname, timeout, self.prvkey)
        except (TimeoutError_, NotLeaderError):
            return False
        process = Process.from_dict(pd)
        self._execute(process)
        return True

    def _execute(self, process: Process) -> None:
        funcname = process.spec.funcname
        fn = self._handlers.get(funcname)
        ctx = ProcessContext(process=process, client=self.client, executor=self)
        if self.workdir_root:
            ctx.workdir = os.path.join(self.workdir_root, process.processid)
            os.makedirs(ctx.workdir, exist_ok=True)
        # Run the handler and deliver the result in separate phases, so a
        # transport failure during delivery is never misread as a handler
        # failure (and vice versa).
        try:
            if fn is None:
                raise ColoniesError(f"no handler for function {funcname!r}")
            self._sync_before(ctx)
            out = fn(ctx, *process.spec.args, **process.spec.kwargs)
            self._sync_after(ctx)
            if out is None:
                out = []
            elif not isinstance(out, list):
                out = [out]
        except Exception as e:  # noqa: BLE001 — report any failure to the broker
            if getattr(e, "simulate_crash", False):
                # Chaos: vanish WITHOUT closing — the broker's maxexectime
                # failsafe must detect the lost lease and re-queue.
                raise
            self.failed += 1
            self._deliver_close(
                process.processid,
                successful=False,
                out=[],
                errors=[f"{type(e).__name__}: {e}", traceback.format_exc(limit=5)],
                counted=True,
            )
            return
        self._deliver_close(
            process.processid, successful=True, out=out, errors=[], counted=False
        )

    # --------------------------------------------------- result delivery
    def _deliver_close(
        self, processid: str, *, successful: bool, out: list, errors: list,
        counted: bool,
    ) -> None:
        """Deliver a close now; journal it for retry if the transport fails."""
        pc = _PendingClose(
            processid=processid,
            successful=successful,
            out=out,
            errors=errors,
            msgid=new_id(),
            counted=counted,
        )
        if not self._try_deliver(pc):
            with self._pending_lock:
                self._pending.append(pc)

    def _try_deliver(self, pc: _PendingClose) -> bool:
        """One delivery attempt. True = settled (delivered or dropped),
        False = journal for another try after ``pc.next_try``."""
        pc.attempts += 1
        try:
            with trace.span("executor.close"):
                if pc.successful:
                    self.client.close(pc.processid, pc.out, self.prvkey, msgid=pc.msgid)
                else:
                    self.client.fail(pc.processid, pc.errors, self.prvkey, msgid=pc.msgid)
        except ConflictError:
            # Lost the lease (failsafe reset while we were computing) —
            # the paper's expected behaviour; drop the result silently.
            if not pc.counted:
                self.failed += 1
            return True
        except (TransportError, TimeoutError_, NotLeaderError):
            if pc.attempts >= PENDING_MAX_ATTEMPTS:
                if not pc.counted:
                    self.failed += 1
                return True
            backoff = min(
                PENDING_BACKOFF_CAP_S,
                PENDING_BACKOFF_BASE_S * 2 ** (pc.attempts - 1),
            )
            pc.next_try = time.monotonic() + backoff * (0.5 + self._rng.random() / 2)
            return False
        except ColoniesError:
            # Application-level rejection (auth, validation): retrying the
            # same request can't succeed.
            if not pc.counted:
                self.failed += 1
            return True
        if not pc.counted:
            self.processed += 1
        return True

    def flush_pending_closes(self, force: bool = False) -> int:
        """Re-deliver journaled closes whose backoff elapsed (all of them
        when ``force``); returns how many remain pending."""
        with self._pending_lock:
            pending, self._pending = self._pending, []
        now = time.monotonic()
        keep = [
            pc
            for pc in pending
            if (not force and now < pc.next_try) or not self._try_deliver(pc)
        ]
        with self._pending_lock:
            self._pending = keep + self._pending
            return len(self._pending)

    # CFS hooks — overridden by executors that mount snapshots (runtime/).
    def _sync_before(self, ctx: ProcessContext) -> None:
        pass

    def _sync_after(self, ctx: ProcessContext) -> None:
        pass

    def run_forever(self, poll_timeout: float = 1.0) -> None:
        consecutive_errors = 0
        while not self._stop.is_set():
            self.flush_pending_closes()
            try:
                self.step(poll_timeout)
            except ColoniesError:
                # Broker unreachable or erroring: back off exponentially
                # (capped, jittered) instead of hammering it every 50 ms.
                consecutive_errors += 1
                self._stop.wait(self._error_backoff(consecutive_errors))
            else:
                consecutive_errors = 0

    def _error_backoff(self, consecutive_errors: int) -> float:
        base = min(
            PENDING_BACKOFF_CAP_S,
            PENDING_BACKOFF_BASE_S * 2 ** min(consecutive_errors - 1, 8),
        )
        return base * (0.5 + self._rng.random() / 2)

    def start(self, poll_timeout: float = 1.0) -> None:
        self._thread = threading.Thread(
            target=self.run_forever, args=(poll_timeout,), daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Graceful drain: give journaled results a last bounded round of
        # delivery attempts instead of discarding computed work.
        for _ in range(3):
            if self.flush_pending_closes(force=True) == 0:
                break
