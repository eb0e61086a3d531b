"""Idempotency classification of every RPC payloadtype (ROBUSTNESS.md).

A copy of the ``SPEC`` table and ``classify`` of the reference's
``repro/core/idempotency.py``: the client stamps a signed ``msgid`` into
every KEYED envelope. Of the broker's per-request helpers, the
request-msgid context (``set_current``/``reset_current``/``current``)
is copied too: the HA broker stamps it onto its replicated ops; and
``reply_colony``, the colony whose share of the dedup table a record
counts against.

Retrying transports give at-least-once delivery; this spec is how the
repo turns that into exactly-once *effect*. Every payloadtype in the
dispatch table is classified:

* ``KEYED`` — mutating and not naturally idempotent: a blind replay
  would duplicate state (two processes for one submit) or conflict
  (double close). The client stamps the envelope with a fresh ``msgid``
  (64-hex, covered by the signature); the server records the reply in a
  bounded per-colony dedup table and replays it on duplicates.
* ``NATURAL`` — mutating but naturally idempotent: replaying converges
  to the same state (approve twice = approved) or fails cleanly without
  corrupting anything (remove twice = NotFoundError). No key needed.
* ``READ`` — no state change; trivially safe to retry.

The reference's table is drift-gated against the broker's dispatch
tables (``python -m repro.analysis.idemlint``); this copy is held equal to
it by ``tests/test_torch_core_client.py``.
"""

from __future__ import annotations

import contextvars

KEYED = "keyed"
NATURAL = "natural"
READ = "read"

# payloadtype -> class, exhaustive over the broker's dispatch tables.
SPEC: dict[str, str] = {
    # keyed: replay would duplicate or conflict
    "submitfunctionspec": KEYED,
    "submitworkflow": KEYED,
    "close": KEYED,
    "addchild": KEYED,
    "assign": KEYED,
    "addcolony": KEYED,
    "addexecutor": KEYED,
    "adduser": KEYED,
    "addfunction": KEYED,
    "addcron": KEYED,
    "runcron": KEYED,
    "addgenerator": KEYED,
    "pack": KEYED,
    "addfile": KEYED,
    "createsnapshot": KEYED,
    # natural: replay converges or fails cleanly
    "approveexecutor": NATURAL,
    "rejectexecutor": NATURAL,
    "removeexecutor": NATURAL,
    "removecron": NATURAL,
    "removegenerator": NATURAL,
    "removefile": NATURAL,
    "removesnapshot": NATURAL,
    # read-only
    "listexecutors": READ,
    "listusers": READ,
    "listfunctions": READ,
    "getprocess": READ,
    "getprocesses": READ,
    "colonystats": READ,
    "getcrons": READ,
    "getgenerators": READ,
    "getfile": READ,
    "getfiles": READ,
    "getsnapshot": READ,
    "getsnapshots": READ,
}


def classify(payloadtype: str) -> str:
    """Unknown payloadtypes default to READ (no key stamped, no dedup)."""
    return SPEC.get(payloadtype, READ)


# The msgid of the request currently being dispatched, so deep callees
# (the close/assign Raft proposals in broker/server.py) can stamp it onto
# the replicated op without threading a parameter through every layer.
_request_msgid: contextvars.ContextVar[str] = contextvars.ContextVar(
    "request_msgid", default=""
)


def set_current(msgid: str) -> contextvars.Token:
    return _request_msgid.set(msgid or "")


def reset_current(token: contextvars.Token) -> None:
    _request_msgid.reset(token)


def current() -> str:
    return _request_msgid.get()


def reply_colony(payloadtype: str, payload: dict, result) -> str:
    """Best-effort colony attribution for a dedup record (for eviction
    accounting only; correctness never depends on it)."""
    if isinstance(payload, dict):
        c = payload.get("colonyname")
        if c:
            return str(c)
        spec = payload.get("spec") or payload.get("workflow") or {}
        if isinstance(spec, dict):
            c = spec.get("conditions", {}).get("colonyname") or spec.get("colonyname")
            if c:
                return str(c)
    if isinstance(result, dict):
        c = result.get("colonyname")
        if c:
            return str(c)
        procs = result.get("processes")
        if isinstance(procs, list) and procs and isinstance(procs[0], dict):
            c = procs[0].get("spec", {}).get("conditions", {}).get("colonyname")
            if c:
                return str(c)
    return ""
