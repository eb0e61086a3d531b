"""Function specifications and workflow specs (paper §3.3, §4.2, Listings 1/2/6).

A copy of the reference's ``repro/core/spec.py``.

A *function specification* is the meta-description of a computation:
what function to run, under what conditions (which executor type, colony,
resources), data-synchronization directives (CFS), and the failsafe
envelope (maxwaittime / maxexectime / maxretries / priority).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Gpu:
    count: int = 0
    name: str = ""

    def to_dict(self) -> dict:
        return {"count": self.count, "name": self.name}

    @staticmethod
    def from_dict(d: dict | None) -> "Gpu":
        d = d or {}
        return Gpu(count=int(d.get("count", 0)), name=d.get("name", ""))


@dataclass
class Conditions:
    """Assignment conditions: which executors may run this process."""

    colonyname: str = ""
    executortype: str = ""
    executornames: list[str] = field(default_factory=list)  # pin to specific executors
    dependencies: list[str] = field(default_factory=list)  # workflow node names
    nodes: int = 1
    processes_per_node: int = 1
    cpu: str = ""
    mem: str = ""
    walltime: int = 0
    gpu: Gpu = field(default_factory=Gpu)

    def to_dict(self) -> dict:
        return {
            "colonyname": self.colonyname,
            "executortype": self.executortype,
            "executornames": list(self.executornames),
            "dependencies": list(self.dependencies),
            "nodes": self.nodes,
            "processes-per-node": self.processes_per_node,
            "cpu": self.cpu,
            "mem": self.mem,
            "walltime": self.walltime,
            "gpu": self.gpu.to_dict(),
        }

    @staticmethod
    def from_dict(d: dict) -> "Conditions":
        return Conditions(
            colonyname=d.get("colonyname", d.get("colonyid", "")),
            executortype=d.get("executortype", ""),
            executornames=list(d.get("executornames", []) or []),
            dependencies=list(d.get("dependencies", []) or []),
            nodes=int(d.get("nodes", 1)),
            processes_per_node=int(d.get("processes-per-node", 1)),
            cpu=d.get("cpu", ""),
            mem=d.get("mem", ""),
            walltime=int(d.get("walltime", 0)),
            gpu=Gpu.from_dict(d.get("gpu")),
        )


@dataclass
class SnapshotMount:
    """One CFS snapshot to materialize before execution (Listing 2 ``fs.snapshots``)."""

    snapshotid: str = ""
    label: str = ""
    dir: str = ""
    keepfiles: bool = False
    keepsnapshot: bool = False

    def to_dict(self) -> dict:
        return {
            "snapshotid": self.snapshotid,
            "label": self.label,
            "dir": self.dir,
            "keepfiles": self.keepfiles,
            "keepsnaphot": self.keepsnapshot,  # sic — field name as in the paper listing
        }

    @staticmethod
    def from_dict(d: dict) -> "SnapshotMount":
        return SnapshotMount(
            snapshotid=d.get("snapshotid", ""),
            label=d.get("label", ""),
            dir=d.get("dir", ""),
            keepfiles=bool(d.get("keepfiles", False)),
            keepsnapshot=bool(d.get("keepsnaphot", d.get("keepsnapshot", False))),
        )


@dataclass
class SyncDir:
    """Bidirectional label<->dir sync directive (download before, upload after)."""

    label: str = ""
    dir: str = ""
    keepfiles: bool = True
    upload: bool = True  # upload results when the process closes

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "dir": self.dir,
            "keepfiles": self.keepfiles,
            "upload": self.upload,
        }

    @staticmethod
    def from_dict(d: dict) -> "SyncDir":
        return SyncDir(
            label=d.get("label", ""),
            dir=d.get("dir", ""),
            keepfiles=bool(d.get("keepfiles", True)),
            upload=bool(d.get("upload", True)),
        )


@dataclass
class Filesystem:
    """CFS data-synchronization block of a function spec (paper §3.4.5)."""

    mount: str = ""
    snapshots: list[SnapshotMount] = field(default_factory=list)
    dirs: list[SyncDir] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "mount": self.mount,
            "snapshots": [s.to_dict() for s in self.snapshots],
            "dirs": [s.to_dict() for s in self.dirs],
        }

    @staticmethod
    def from_dict(d: dict | None) -> "Filesystem":
        d = d or {}
        return Filesystem(
            mount=d.get("mount", ""),
            snapshots=[SnapshotMount.from_dict(s) for s in d.get("snapshots", []) or []],
            dirs=[SyncDir.from_dict(s) for s in d.get("dirs", []) or []],
        )


@dataclass
class FunctionSpec:
    """The paper's function specification (Listing 1 / Listing 2)."""

    funcname: str = ""
    nodename: str = ""  # set for workflow nodes
    args: list[Any] = field(default_factory=list)
    kwargs: dict[str, Any] = field(default_factory=dict)
    conditions: Conditions = field(default_factory=Conditions)
    priority: int = 0
    maxwaittime: int = -1  # seconds in queue before the process fails; -1 = forever
    maxexectime: int = -1  # seconds an executor may hold the process; -1 = unbounded
    maxretries: int = 3
    fs: Filesystem = field(default_factory=Filesystem)
    label: str = ""
    env: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "funcname": self.funcname,
            "nodename": self.nodename,
            "args": list(self.args),
            "kwargs": dict(self.kwargs),
            "conditions": self.conditions.to_dict(),
            "priority": self.priority,
            "maxwaittime": self.maxwaittime,
            "maxexectime": self.maxexectime,
            "maxretries": self.maxretries,
            "fs": self.fs.to_dict(),
            "label": self.label,
            "env": dict(self.env),
        }

    @staticmethod
    def from_dict(d: dict) -> "FunctionSpec":
        return FunctionSpec(
            funcname=d.get("funcname", ""),
            nodename=d.get("nodename", ""),
            args=list(d.get("args", []) or []),
            kwargs=dict(d.get("kwargs", {}) or {}),
            conditions=Conditions.from_dict(d.get("conditions", {}) or {}),
            priority=int(d.get("priority", 0)),
            maxwaittime=int(d.get("maxwaittime", -1)),
            maxexectime=int(d.get("maxexectime", -1)),
            maxretries=int(d.get("maxretries", 3)),
            fs=Filesystem.from_dict(d.get("fs")),
            label=d.get("label", ""),
            env=dict(d.get("env", {}) or {}),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "FunctionSpec":
        return FunctionSpec.from_dict(json.loads(s))


@dataclass
class WorkflowSpec:
    """A DAG of function specs; edges come from ``conditions.dependencies``."""

    colonyname: str = ""
    name: str = ""
    specs: list[FunctionSpec] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "colonyname": self.colonyname,
            "name": self.name,
            "functionspecs": [s.to_dict() for s in self.specs],
        }

    @staticmethod
    def from_dict(d: dict) -> "WorkflowSpec":
        specs = d.get("functionspecs")
        if specs is None and isinstance(d, list):  # bare JSON list (Listing 6)
            specs = d
        return WorkflowSpec(
            colonyname=d.get("colonyname", "") if isinstance(d, dict) else "",
            name=d.get("name", "") if isinstance(d, dict) else "",
            specs=[FunctionSpec.from_dict(s) for s in (specs or [])],
        )

    @staticmethod
    def from_json(s: str) -> "WorkflowSpec":
        d = json.loads(s)
        if isinstance(d, list):
            return WorkflowSpec(specs=[FunctionSpec.from_dict(x) for x in d])
        return WorkflowSpec.from_dict(d)

    def validate(self) -> None:
        from .errors import ValidationError

        names = [s.nodename for s in self.specs]
        if len(set(names)) != len(names):
            raise ValidationError("duplicate nodename in workflow")
        known = set(names)
        for s in self.specs:
            for dep in s.conditions.dependencies:
                if dep not in known:
                    raise ValidationError(f"unknown dependency {dep!r} in node {s.nodename!r}")
        # cycle check (Kahn)
        indeg = {n: 0 for n in names}
        children: dict[str, list[str]] = {n: [] for n in names}
        for s in self.specs:
            for dep in s.conditions.dependencies:
                indeg[s.nodename] += 1
                children[dep].append(s.nodename)
        queue = [n for n, d in indeg.items() if d == 0]
        seen = 0
        while queue:
            n = queue.pop()
            seen += 1
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if seen != len(names):
            raise ValidationError("workflow DAG contains a cycle")
