"""Generators, trimmed from the reference's ``repro/core/generator.py``:
threshold-triggered workflow templates (paper §3.4.4).

A ``pack`` only appends one datum to the generator's bucket. The
server's background tick fires a generator once ``queuesize`` data have
accumulated, or ``timeout`` seconds after the first pending one: it
drains the bucket and submits the template workflow with the packed data
in its root nodes' ``packed_args``. Serving batches requests this way
(``serve/batcher.py``). The pending data are the database's list bucket
``PACKS_TABLE``, the reference's table name, so a database file written
by either package's broker keeps its pending packs in the other's.
"""

from __future__ import annotations

import secrets
from typing import Any, Callable

from ..core.errors import NotFoundError, ValidationError
from ..core.process import now_ns
from ..core.spec import WorkflowSpec

PACKS_TABLE = "generator_packs"


class GeneratorExtension:
    def __init__(self, server) -> None:
        self.server = server
        self.db = server.db
        server.extensions.append(self)

    def handlers(self) -> dict[str, Callable[[str, dict], Any]]:
        return {
            "addgenerator": self._h_add_generator,
            "getgenerators": self._h_get_generators,
            "removegenerator": self._h_remove_generator,
            "pack": self._h_pack,
        }

    def _h_add_generator(self, identity: str, payload: dict) -> dict:
        g = payload["generator"]
        colony = g.get("colonyname", "")
        self.server._require_member(identity, colony)
        wf = WorkflowSpec.from_dict(g.get("workflow", {}))
        if not wf.specs:
            raise ValidationError("generator needs a workflow template")
        for s in wf.specs:
            s.conditions.colonyname = s.conditions.colonyname or colony
        wf.colonyname = colony
        wf.validate()
        queuesize = int(g.get("queuesize", 1))
        if queuesize < 1:
            raise ValidationError("queuesize must be >= 1")
        entry = {
            "generatorid": secrets.token_hex(16),
            "colonyname": colony,
            "name": g.get("name", ""),
            "workflow": wf.to_dict(),
            "queuesize": queuesize,
            "timeout": float(g.get("timeout", 0)),  # seconds; 0 = only threshold
            "firstpack": 0,
            "runs": 0,
            "added": now_ns(),
        }
        self.db.generator_put(entry)
        return entry

    def _h_get_generators(self, identity: str, payload: dict) -> list[dict]:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        return [dict(e, pending=self.db.kv_len(PACKS_TABLE, e["generatorid"]))
                for e in self.db.generator_list(colony)]

    def _h_remove_generator(self, identity: str, payload: dict) -> dict:
        gid = payload["generatorid"]
        entry = self.db.generator_get(gid)
        if entry is None:
            raise NotFoundError("generator not found")
        self.server._require_member(identity, entry["colonyname"])
        self.db.generator_del(gid)
        self.db.kv_take_all(PACKS_TABLE, gid)
        return {"generatorid": gid, "removed": True}

    def _h_pack(self, identity: str, payload: dict) -> dict:
        gid = payload["generatorid"]
        entry = self.db.generator_get(gid)
        if entry is None:
            raise NotFoundError("generator not found")
        self.server._require_member(identity, entry["colonyname"])
        n = self.db.kv_append(PACKS_TABLE, gid, {"arg": payload.get("arg"), "ts": now_ns()})
        if entry.get("firstpack", 0) == 0:
            entry["firstpack"] = now_ns()
            self.db.generator_put(entry)
        return {"generatorid": gid, "pending": n}

    def tick(self) -> int:
        ts = now_ns()
        fired = 0
        for entry in self.db.generator_all():
            pending = self.db.kv_len(PACKS_TABLE, entry["generatorid"])
            if pending == 0:
                continue
            timed_out = (entry.get("timeout", 0) > 0 and entry.get("firstpack", 0) > 0
                         and ts - entry["firstpack"] > entry["timeout"] * 1e9)
            if pending >= entry["queuesize"] or timed_out:
                self._fire(entry)
                fired += 1
        return fired

    def _fire(self, entry: dict) -> None:
        packs = self.db.kv_take_all(PACKS_TABLE, entry["generatorid"])
        if not packs:
            return
        args = [p["arg"] for p in packs]
        wf = WorkflowSpec.from_dict(entry["workflow"])
        for s in wf.specs:  # the packed data go to the DAG's roots
            if not s.conditions.dependencies:
                s.kwargs = dict(s.kwargs, packed_args=args)
        self.server.submit_workflow_processes(wf)
        self.db.generator_put(dict(entry, firstpack=0, runs=entry.get("runs", 0) + 1))
        self.server._notify_queue()
