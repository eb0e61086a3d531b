"""Idempotency classification of every RPC payloadtype (ROBUSTNESS.md).

A copy of the ``SPEC`` table and ``classify`` of the reference's
``repro/core/idempotency.py``: the client stamps a signed ``msgid`` into
every KEYED envelope. The broker's per-request helpers are not copied.

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
