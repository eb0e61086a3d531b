"""Deterministic fault injection for the RPC path (ROBUSTNESS.md).

A copy of the reference's ``repro/runtime/faults.py``: the same sites,
rules, actions and seeded schedule. Stdlib only, so the broker process
(which loads no torch) can import it; its lock (``faults``, from
``analysis.locktrack.make_lock``) is one that nothing is called under.

The paper's failsafe story (§3.4) assumes executors die at any moment;
this module lets tests make the *rest* of the path — transports, the
server's dispatch/commit/reply window, database commits, raft ticks —
just as unreliable, deterministically.

Named fault points are compiled into the code (see the catalog below);
each is a single ``faults.hit(site, **ctx)`` call that reads one module
global and returns immediately when no plan is installed — zero cost in
production. A test activates a :class:`FaultPlan` (a list of
:class:`FaultRule` schedules plus a seeded RNG for probabilistic soak
rules) via the ``active()`` context manager; no environment variables
are involved.

Fault-point catalog (site → where it fires):

* ``transport.send``    — client transport, before the request is
  delivered (a fault here means the server never saw the request).
* ``transport.recv``    — client transport, after the reply was produced
  (a fault here means the server committed but the client never heard).
* ``server.pre_dispatch``  — ``ColoniesServer.handle``, after envelope
  verification but before the handler (and before the idempotency-replay
  check): the request dies server-side with no effect.
* ``server.post_commit`` — ``ColoniesServer.handle``, after the handler
  committed *and* the dedup record was written, before the reply is
  returned: the classic crash-after-commit-before-reply window.
* ``db.commit``         — entry of ``add_process`` / ``update_process``
  (both backends): the write itself fails.
* ``raft.tick``         — the HA event loop, once per tick: a raised
  fault skips the tick, a delay stalls it (forcing election churn).
* ``blob.put`` / ``blob.get`` — the CFS blob plane, once per
  child-shard operation inside ``ShardedStorage`` (ctx carries
  ``shard`` and ``key``): a raised fault models a dead storage shard,
  which puts tolerate (R−1 replicas may fail) and gets rotate past
  (read-repair rewrites the copies observed broken; see STORAGE.md).

Actions:

* ``drop`` / ``reset`` / ``crash`` — raise :class:`FaultInjected`
  (a ``ConnectionError``) at the site. The three names describe intent
  at different sites (request lost / connection reset before reply /
  process died) but behave identically; transports translate the raise
  into a retryable 503.
* ``delay`` — sleep ``delay_s`` seconds at the site, then continue.
* ``duplicate`` — returned to the caller as the string ``"duplicate"``;
  transports respond by delivering the request twice (at-least-once
  delivery made flesh).
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..analysis.locktrack import make_lock

RAISING_ACTIONS = frozenset({"drop", "reset", "crash"})
ACTIONS = RAISING_ACTIONS | {"delay", "duplicate"}

SITES = frozenset(
    {
        "transport.send",
        "transport.recv",
        "server.pre_dispatch",
        "server.post_commit",
        "db.commit",
        "raft.tick",
        "blob.put",
        "blob.get",
    }
)


class FaultInjected(ConnectionError):
    """Raised at a fault point for drop/reset/crash actions.

    Deliberately NOT a ColoniesError: it models infrastructure failure,
    so server dispatch never converts it into a clean RPC error reply —
    transports see a dead connection, exactly like the real thing.
    """


@dataclass
class FaultRule:
    """One scheduled fault: fire ``action`` at ``site``.

    Deterministic scheduling: the rule matches its ``site`` (and
    ``payloadtype``/``match`` if set), skips the first ``after``
    matches, then fires on the next ``times`` matches (``None`` =
    forever). ``prob`` < 1 makes firing probabilistic via the plan's
    seeded RNG — same seed, same schedule.
    """

    site: str
    action: str
    payloadtype: str | None = None  # match ctx["payloadtype"] when set
    match: dict = field(default_factory=dict)  # extra ctx equality matches
    after: int = 0  # skip the first N matching hits
    times: int | None = 1  # fire on at most N hits (None = unlimited)
    delay_s: float = 0.01  # for action == "delay"
    prob: float = 1.0  # firing probability (plan RNG)
    # counters (managed by the plan, under its lock)
    matched: int = 0
    fired: int = 0

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} (see {sorted(SITES)})")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")

    def _matches(self, site: str, ctx: dict) -> bool:
        if site != self.site:
            return False
        if self.payloadtype is not None and ctx.get("payloadtype") != self.payloadtype:
            return False
        for k, v in self.match.items():
            if ctx.get(k) != v:
                return False
        return True


class FaultPlan:
    """A seeded, schedule-driven set of fault rules.

    Install with :func:`install`/:func:`uninstall` or the
    :func:`active` context manager. ``plan.log`` records every fired
    fault as ``(site, action, ctx)`` for test assertions.
    """

    def __init__(self, rules: list[FaultRule] | None = None, seed: int = 0) -> None:
        self.rules = list(rules or [])
        self.rng = random.Random(seed)
        self.log: list[tuple[str, str, dict]] = []
        # Leaf lock: only dict/list ops are performed under it, and the
        # delay sleep happens after release (see CONCURRENCY.md).
        self._lock = make_lock("faults")

    def add(self, rule: FaultRule) -> "FaultPlan":
        self.rules.append(rule)
        return self

    def fired(self, site: str | None = None) -> int:
        with self._lock:
            return sum(
                1 for s, _a, _c in self.log if site is None or s == site
            )

    def fire(self, site: str, ctx: dict) -> str | None:
        """Evaluate rules for one fault-point hit (first match wins)."""
        with self._lock:
            action = None
            delay_s = 0.0
            for rule in self.rules:
                if not rule._matches(site, ctx):
                    continue
                rule.matched += 1
                if rule.matched <= rule.after:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.prob < 1.0 and self.rng.random() >= rule.prob:
                    continue
                rule.fired += 1
                self.log.append((site, rule.action, dict(ctx)))
                action = rule.action
                delay_s = rule.delay_s
                break
        if action is None:
            return None
        if action == "delay":
            time.sleep(delay_s)
            return None
        if action in RAISING_ACTIONS:
            raise FaultInjected(f"injected {action} at {site} ({ctx})")
        return action  # "duplicate": interpreted by the transport


# ---------------------------------------------------------------------------
# Module-level activation (per-test, no env vars)
# ---------------------------------------------------------------------------

_plan: FaultPlan | None = None
_install_guard = threading.Lock()


def install(plan: FaultPlan) -> None:
    global _plan
    with _install_guard:
        if _plan is not None:
            raise RuntimeError("a FaultPlan is already installed")
        _plan = plan


def uninstall() -> None:
    global _plan
    with _install_guard:
        _plan = None


def current() -> FaultPlan | None:
    return _plan


@contextmanager
def active(plan: FaultPlan):
    """``with faults.active(plan): ...`` — install for the block only."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def hit(site: str, **ctx) -> str | None:
    """The fault point. Zero-cost when no plan is installed."""
    plan = _plan
    if plan is None:
        return None
    return plan.fire(site, ctx)
