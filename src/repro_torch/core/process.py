"""Processes and the priority-time queue ordering (paper §3, Table 1, Eq. 1).

A copy of ``Process``, the states and ``new_id``/``now_ns`` from the
reference's ``repro/core/process.py``: what an executor reads from an
assignment.

A process is the meta-information record of one computation: the function
spec plus execution context (state, assigned executor, retries, deadlines,
dataflow input/output, and DAG linkage).
"""

from __future__ import annotations

import json
import secrets
import time
from dataclasses import dataclass, field
from typing import Any

from .spec import FunctionSpec

# Process states (paper Fig. 2 / Table 1)
WAITING = "waiting"
RUNNING = "running"
SUCCESSFUL = "successful"
FAILED = "failed"

STATES = (WAITING, RUNNING, SUCCESSFUL, FAILED)

# Eq. (1): priority_time = submission_ns - priority * 1e9 * 60 * 60 * 24
# i.e. each priority level buys a full day of virtual queue seniority.
PRIORITY_NS_PER_LEVEL = 10**9 * 60 * 60 * 24


def priority_time(submission_ns: int, priority: int) -> int:
    """Paper Eq. (1) for a nanosecond timestamp."""
    return submission_ns - priority * PRIORITY_NS_PER_LEVEL


def new_id() -> str:
    return secrets.token_hex(32)


def now_ns() -> int:
    return time.time_ns()


@dataclass
class Process:
    processid: str = field(default_factory=new_id)
    colonyname: str = ""
    spec: FunctionSpec = field(default_factory=FunctionSpec)
    state: str = WAITING
    assignedexecutorid: str = ""
    isassigned: bool = False
    wait_for_parents: bool = False
    submissiontime_ns: int = 0
    starttime_ns: int = 0
    endtime_ns: int = 0
    deadline_ns: int = 0  # maxexectime deadline; 0 = none
    waitdeadline_ns: int = 0  # maxwaittime deadline; 0 = none
    retries: int = 0
    priority_time: int = 0
    # Dataflow (paper Table 4)
    inputs: list[Any] = field(default_factory=list)
    output: list[Any] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
    # DAG linkage (paper Table 3)
    workflowid: str = ""
    parents: list[str] = field(default_factory=list)  # parent process ids
    children: list[str] = field(default_factory=list)  # child process ids

    @staticmethod
    def create(spec: FunctionSpec, submission_ns: int | None = None) -> "Process":
        ts = now_ns() if submission_ns is None else submission_ns
        p = Process(
            colonyname=spec.conditions.colonyname,
            spec=spec,
            submissiontime_ns=ts,
            priority_time=priority_time(ts, spec.priority),
        )
        if spec.maxwaittime and spec.maxwaittime > 0:
            p.waitdeadline_ns = ts + spec.maxwaittime * 10**9
        return p

    @property
    def queue_ready(self) -> bool:
        """True iff this process may occupy a ready queue (assignable)."""
        return self.state == WAITING and not self.wait_for_parents

    def to_dict(self) -> dict:
        return {
            "processid": self.processid,
            "colonyname": self.colonyname,
            "spec": self.spec.to_dict(),
            "state": self.state,
            "assignedexecutorid": self.assignedexecutorid,
            "isassigned": self.isassigned,
            "waitforparents": self.wait_for_parents,
            "submissiontime": self.submissiontime_ns,
            "starttime": self.starttime_ns,
            "endtime": self.endtime_ns,
            "deadline": self.deadline_ns,
            "waitdeadline": self.waitdeadline_ns,
            "retries": self.retries,
            "prioritytime": self.priority_time,
            "in": list(self.inputs),
            "out": list(self.output),
            "errors": list(self.errors),
            "workflowid": self.workflowid,
            "parents": list(self.parents),
            "children": list(self.children),
        }

    @staticmethod
    def from_dict(d: dict) -> "Process":
        return Process(
            processid=d["processid"],
            colonyname=d.get("colonyname", ""),
            spec=FunctionSpec.from_dict(d.get("spec", {})),
            state=d.get("state", WAITING),
            assignedexecutorid=d.get("assignedexecutorid", ""),
            isassigned=bool(d.get("isassigned", False)),
            wait_for_parents=bool(d.get("waitforparents", False)),
            submissiontime_ns=int(d.get("submissiontime", 0)),
            starttime_ns=int(d.get("starttime", 0)),
            endtime_ns=int(d.get("endtime", 0)),
            deadline_ns=int(d.get("deadline", 0)),
            waitdeadline_ns=int(d.get("waitdeadline", 0)),
            retries=int(d.get("retries", 0)),
            priority_time=int(d.get("prioritytime", 0)),
            inputs=list(d.get("in", []) or []),
            output=list(d.get("out", []) or []),
            errors=list(d.get("errors", []) or []),
            workflowid=d.get("workflowid", ""),
            parents=list(d.get("parents", []) or []),
            children=list(d.get("children", []) or []),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Process":
        return Process.from_dict(json.loads(s))
