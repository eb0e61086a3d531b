"""Cron — stateless time-based workflow triggering (paper §3.4.3).

Two-step leader protocol, exactly as the paper describes:
  1. the elected leader computes a *future deadline* for each cron entry
     and stores it in the cron table;
  2. the leader periodically scans the table; when ``now > deadline`` it
     submits the workflow and writes the next deadline.

No session state lives in memory between scans, so leader failover simply
resumes scanning from the table.

Supports plain intervals and 5-field cron expressions
(minute hour day-of-month month day-of-week; ``*``, ``*/n``, lists, ranges).

A copy of the reference's ``repro/core/cron.py``, stdlib only.
"""

from __future__ import annotations

import secrets
import time
from typing import Any, Callable

from ..core.errors import NotFoundError, ValidationError
from ..core.process import now_ns
from ..core.spec import WorkflowSpec


# ---------------------------------------------------------------------------
# Tiny 5-field cron expression parser
# ---------------------------------------------------------------------------


def _parse_field(expr: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in expr.split(","):
        orig = part
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValidationError(f"cron step must be positive in {expr!r}")
        if part in ("*", ""):
            start, stop = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, stop = int(a), int(b)
        else:
            # Vixie expands a lone number before '/' to an N-to-max range:
            # '5/15' in the minute field is {5, 20, 35, 50}, not {5}.
            start = int(part)
            stop = hi if "/" in orig else start
        # Steps anchor at the range start (standard cron): 11-20/5 is
        # {11, 16}, not the field-minimum-anchored {15, 20}.
        for v in range(start, stop + 1, step):
            if lo <= v <= hi:
                out.add(v)
    if not out:
        raise ValidationError(f"empty cron field {expr!r}")
    return out


def next_cron_deadline_ns(cronexpr: str, after_ns: int) -> int:
    """Next matching minute boundary strictly after ``after_ns``."""
    fields = cronexpr.split()
    if len(fields) != 5:
        raise ValidationError("cron expression must have 5 fields")
    minutes = _parse_field(fields[0], 0, 59)
    hours = _parse_field(fields[1], 0, 23)
    doms = _parse_field(fields[2], 1, 31)
    months = _parse_field(fields[3], 1, 12)
    # Standard cron day-of-week: 0 = Sunday, with 7 accepted as Sunday too.
    # Python's tm_wday is 0 = Monday, so translate at match time.
    dows = {d % 7 for d in _parse_field(fields[4], 0, 7)}
    # Vixie-cron day rule: if BOTH day fields are restricted, a day matches
    # when EITHER does ('0 0 13 * 5' = every 13th and every Friday, not
    # just Friday-the-13th); otherwise the restricted one decides. Like
    # Vixie's DOM_STAR/DOW_STAR, a '*'-prefixed field ('*/2') counts as a
    # star field even though it constrains the match.
    dom_any = fields[2].strip().startswith("*")
    dow_any = fields[4].strip().startswith("*")
    t = (after_ns // (60 * 10**9) + 1) * 60  # next minute boundary, seconds
    for _ in range(366 * 24 * 60):  # bounded search: one year of minutes
        st = time.localtime(t)
        dom_ok = st.tm_mday in doms
        dow_ok = (st.tm_wday + 1) % 7 in dows
        day_ok = (dom_ok or dow_ok) if not dom_any and not dow_any else (
            dom_ok and dow_ok
        )
        if (
            st.tm_min in minutes
            and st.tm_hour in hours
            and st.tm_mon in months
            and day_ok
        ):
            return t * 10**9
        t += 60
    raise ValidationError(f"cron expression {cronexpr!r} never fires")


# ---------------------------------------------------------------------------
# Server extension
# ---------------------------------------------------------------------------


class CronExtension:
    """Leader-scanned cron table; registered on a ColoniesServer."""

    def __init__(self, server) -> None:
        self.server = server
        self.db = server.db
        server.extensions.append(self)
        self.triggered = 0  # observability for tests/benchmarks

    def handlers(self) -> dict[str, Callable[[str, dict], Any]]:
        return {
            "addcron": self._h_add_cron,
            "getcrons": self._h_get_crons,
            "removecron": self._h_remove_cron,
            "runcron": self._h_run_cron,
        }

    def _h_add_cron(self, identity: str, payload: dict) -> dict:
        c = payload["cron"]
        colony = c.get("colonyname", "")
        self.server._require_member(identity, colony)
        wf = WorkflowSpec.from_dict(c.get("workflow", {}))
        if not wf.specs:
            raise ValidationError("cron needs a workflow")
        for s in wf.specs:
            s.conditions.colonyname = s.conditions.colonyname or colony
        wf.colonyname = colony
        wf.validate()
        interval = float(c.get("interval", 0))
        cronexpr = c.get("cronexpr", "")
        if interval <= 0 and not cronexpr:
            raise ValidationError("cron needs interval > 0 or a cronexpr")
        ts = now_ns()
        entry = {
            "cronid": secrets.token_hex(16),
            "colonyname": colony,
            "name": c.get("name", ""),
            "interval": interval,
            "cronexpr": cronexpr,
            "workflow": wf.to_dict(),
            # Step 1 of the two-step protocol: the future deadline.
            "deadline": self._next_deadline(interval, cronexpr, ts),
            "lastrun": 0,
            "runs": 0,
            "lastworkflowid": "",
            "added": ts,
        }
        self.db.cron_put(entry)
        return entry

    @staticmethod
    def _next_deadline(interval: float, cronexpr: str, after_ns: int) -> int:
        if cronexpr:
            return next_cron_deadline_ns(cronexpr, after_ns)
        return after_ns + int(interval * 1e9)

    def _h_get_crons(self, identity: str, payload: dict) -> list[dict]:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        return self.db.cron_list(colony)

    def _h_remove_cron(self, identity: str, payload: dict) -> dict:
        cronid = payload["cronid"]
        entry = self.db.cron_get(cronid)
        if entry is None:
            raise NotFoundError("cron not found")
        self.server._require_member(identity, entry["colonyname"])
        self.db.cron_del(cronid)
        return {"cronid": cronid, "removed": True}

    def _h_run_cron(self, identity: str, payload: dict) -> dict:
        """Force-fire a cron now (CLI convenience)."""
        cronid = payload["cronid"]
        entry = self.db.cron_get(cronid)
        if entry is None:
            raise NotFoundError("cron not found")
        self.server._require_member(identity, entry["colonyname"])
        return self._fire(entry, now_ns())

    # -- leader scan (step 2) -------------------------------------------------
    def tick(self) -> int:
        """Fire everything past deadline via the deadline index. Leader-only.

        ``cron_due`` hands back only the entries past their deadline, read
        from a deadline index (a heap in memory, ``idx_crons_deadline`` in
        sqlite).
        """
        ts = now_ns()
        fired = 0
        for entry in self.db.cron_due(ts):
            self._fire(entry, ts)
            fired += 1
        return fired

    def _fire(self, entry: dict, ts: int) -> dict:
        wf = WorkflowSpec.from_dict(entry["workflow"])
        procs = self.server.submit_workflow_processes(wf)
        entry = dict(entry)
        entry["deadline"] = self._next_deadline(entry["interval"], entry["cronexpr"], ts)
        entry["lastrun"] = ts
        entry["runs"] = entry.get("runs", 0) + 1
        entry["lastworkflowid"] = procs[0].workflowid
        self.db.cron_put(entry)
        self.server._notify_queue()
        self.triggered += 1
        return entry
