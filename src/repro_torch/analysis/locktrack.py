"""Runtime lock-order detector (the dynamic half of the concurrency lint).

A copy of the reference's ``repro/analysis/locktrack.py``, with the same
families and the same ``REPRO_LOCK_CHECK`` switch. The broker has four
lock families with a documented acquisition order (TORCH_CONTRACTS.md): server-level colony/shard locks outermost, then the
database registry lock ``_glock`` as a *leaf* (nothing may be acquired
while holding it), CFS shard locks independent of broker shard locks, and
Raft/cluster leader-local locks that must never nest inside database
locks. This module makes that order machine-checked:

* :func:`make_lock` is the single lock factory of the broker
  (``broker/{database,server,cluster,raft}.py``), ``core/fs.py``,
  ``core/blobstore.py`` and ``runtime/faults.py``. Disabled (the default), it
  returns a plain ``threading.RLock`` — zero overhead. Enabled via
  ``REPRO_LOCK_CHECK=1`` or :func:`enable`, it returns a
  :class:`TrackedRLock`.
* :class:`TrackedRLock` records, per thread, the ordered set of held
  locks. Each first (non-reentrant) acquisition checks:

  - **acquire-under-leaf** — acquiring anything while holding a lock in a
    leaf family (``_glock`` must guard only straight-line dict ops);
  - **cross-instance** — acquiring a second instance of an exclusive
    family (e.g. colony shard A's lock while holding colony shard B's:
    the broker never nests colonies, so this is a latent deadlock);
  - **lock-order-cycle** — the new (held-family → acquired-family) edge
    closes a cycle in the global lock-order graph, i.e. two code paths
    acquire the same families in opposite orders;
  - **wait-under-lock** — a ``Condition`` built on a tracked lock started
    waiting while the thread still held other tracked locks (blocking
    while holding a shared lock starves every other acquirer), unless
    the pairing is declared deadlock-free via :func:`allow_wait`.

Violations are *recorded*, not raised (raising mid-acquisition would
corrupt unrelated state); tests and CI assert :func:`violations` is
empty. Contract decorators (contracts.py) raise, because they guard
single functions and a violation there is a programming error at a
well-defined boundary.

Tracked locks also record **hold times**: per family, the count of
holds, total/max held nanoseconds, and which instance held longest.
Time under a ``Condition.wait()`` does not count as holding (the lock
is released while parked). Holds longer than the warn threshold
(``REPRO_LOCK_HOLD_WARN_MS``, default 50ms, or :func:`set_hold_warn_ms`)
are logged via :func:`hold_warnings` — kept separate from
:func:`violations` so a slow CI box never fails the correctness gate —
and the atexit summary prints the top holders by max hold time.

Lock names are ``"family"`` or ``"family:instance"``; the family is the
text before the first ``:``.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time

# Families that must guard only straight-line, non-blocking code: nothing
# may be acquired while one is held.
LEAF_FAMILIES = frozenset({"glock"})

# Families whose instances never legitimately nest with each other
# (per-colony shards, per-colony CFS shards, per-colony server locks,
# per-node Raft locks, per-database registry/connection locks).
EXCLUSIVE_FAMILIES = frozenset(
    {"glock", "shard", "cfs", "sqlite", "dbcolony", "assignlocal", "raft"}
)

# Declared wait-under-lock allowances: condition family -> families that
# may stay held across a wait on it. Empty by default; a caller that
# proves the pairing deadlock-free (the notifier never acquires the held
# family) registers it via :func:`allow_wait` next to the wait site.
_WAIT_ALLOWED: dict[str, frozenset[str]] = {}


def allow_wait(cond_family: str, *holding: str) -> None:
    """Declare a condition wait on ``cond_family`` safe while holding
    locks from ``holding`` families.

    Wait-under-lock is a violation because the parked thread blocks
    every acquirer of what it still holds — *and* deadlocks if the
    notifier needs one of those locks. An allowance is a contract that
    neither applies: register it at the wait site with a comment proving
    the notifying thread never touches the held family. Any held lock
    outside the declared families still fires.
    """
    _WAIT_ALLOWED[cond_family] = _WAIT_ALLOWED.get(
        cond_family, frozenset()
    ) | frozenset(holding)


class _Registry:
    """Global detector state: the lock-order graph and the violation log."""

    def __init__(self) -> None:
        # A plain, untracked lock: the registry must never feed itself.
        self.guard = threading.Lock()
        self.enabled = os.environ.get("REPRO_LOCK_CHECK", "") not in ("", "0")
        # (held_family, acquired_family) -> first-seen "lockA -> lockB"
        self.edges: dict[tuple[str, str], str] = {}
        self.violations: list[dict] = []
        # family -> {count, total_ns, max_ns, max_lock}
        self.holds: dict[str, dict] = {}
        self.hold_warnings: list[dict] = []
        self.hold_warn_ns = int(
            float(os.environ.get("REPRO_LOCK_HOLD_WARN_MS", "50")) * 1e6
        )


_REG = _Registry()
_TLS = threading.local()


def _held() -> dict["TrackedRLock", int]:
    """This thread's held tracked locks, in acquisition order, with counts."""
    d = getattr(_TLS, "held", None)
    if d is None:
        d = _TLS.held = {}
    return d


def _hold_t0() -> dict["TrackedRLock", int]:
    """Per-thread monotonic_ns timestamp of each lock's outermost acquire."""
    d = getattr(_TLS, "hold_t0", None)
    if d is None:
        d = _TLS.hold_t0 = {}
    return d


def is_enabled() -> bool:
    return _REG.enabled


def enable(on: bool = True) -> None:
    """Toggle tracking at runtime (tests). Only affects locks created after."""
    _REG.enabled = on


def reset() -> None:
    """Clear the order graph, violation log, and hold stats (test isolation)."""
    with _REG.guard:
        _REG.edges.clear()
        _REG.violations.clear()
        _REG.holds.clear()
        _REG.hold_warnings.clear()


def violations() -> list[dict]:
    with _REG.guard:
        return [dict(v) for v in _REG.violations]


def order_edges() -> dict[tuple[str, str], str]:
    with _REG.guard:
        return dict(_REG.edges)


def hold_stats() -> dict[str, dict]:
    """Per-family hold-time stats: count, total_ns, max_ns, mean_ns, max_lock."""
    with _REG.guard:
        out = {}
        for fam, st in _REG.holds.items():
            d = dict(st)
            d["mean_ns"] = st["total_ns"] / st["count"] if st["count"] else 0.0
            out[fam] = d
        return out


def hold_warnings() -> list[dict]:
    """Holds that exceeded the warn threshold (not counted as violations)."""
    with _REG.guard:
        return [dict(w) for w in _REG.hold_warnings]


def set_hold_warn_ms(ms: float) -> None:
    """Set the long-hold warn threshold (tests / tuning)."""
    with _REG.guard:
        _REG.hold_warn_ns = int(ms * 1e6)


def _record_hold(lock: "TrackedRLock", dur_ns: int) -> None:
    with _REG.guard:
        st = _REG.holds.get(lock.family)
        if st is None:
            st = _REG.holds[lock.family] = {
                "count": 0,
                "total_ns": 0,
                "max_ns": 0,
                "max_lock": lock.name,
            }
        st["count"] += 1
        st["total_ns"] += dur_ns
        if dur_ns > st["max_ns"]:
            st["max_ns"] = dur_ns
            st["max_lock"] = lock.name
        if dur_ns >= _REG.hold_warn_ns:
            _REG.hold_warnings.append(
                {
                    "lock": lock.name,
                    "family": lock.family,
                    "held_ns": dur_ns,
                    "thread": threading.current_thread().name,
                }
            )


def _record(kind: str, msg: str) -> None:
    with _REG.guard:
        _REG.violations.append(
            {"kind": kind, "msg": msg, "thread": threading.current_thread().name}
        )


def _cycle_after(edges: dict[tuple[str, str], str], src: str, dst: str) -> list[str] | None:
    """After adding src->dst: a dst ~> src path means the edge closed a cycle."""
    adj: dict[str, list[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    stack: list[tuple[str, list[str]]] = [(dst, [dst])]
    seen = {dst}
    while stack:
        node, path = stack.pop()
        if node == src:
            return path + [dst]
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class TrackedRLock:
    """Reentrant lock that feeds the order detector on every acquisition.

    Drop-in for ``threading.RLock``, including the private
    ``_is_owned``/``_release_save``/``_acquire_restore`` hooks that
    ``threading.Condition`` uses — so a Condition built on a TrackedRLock
    keeps the held-set accurate across ``wait()`` (and flags waits
    entered while other tracked locks are held).
    """

    __slots__ = ("name", "family", "_inner")

    def __init__(self, name: str) -> None:
        self.name = name
        self.family = name.split(":", 1)[0]
        self._inner = threading.RLock()

    def __repr__(self) -> str:
        return f"TrackedRLock({self.name!r})"

    # -- detector ----------------------------------------------------------
    def _check_acquire(self) -> None:
        held = _held()
        if self in held:  # reentrant re-acquire: no new ordering information
            return
        for other in held:
            if other.family in LEAF_FAMILIES:
                _record(
                    "acquire-under-leaf",
                    f"acquiring {self.name} while holding leaf lock {other.name}",
                )
            elif other.family == self.family:
                if self.family in EXCLUSIVE_FAMILIES:
                    _record(
                        "cross-instance",
                        f"acquiring {self.name} while holding {other.name}"
                        " (same exclusive family)",
                    )
            else:
                self._note_edge(other)

    def _note_edge(self, other: "TrackedRLock") -> None:
        key = (other.family, self.family)
        with _REG.guard:
            if key in _REG.edges:
                return
            _REG.edges[key] = f"{other.name} -> {self.name}"
            cycle = _cycle_after(_REG.edges, other.family, self.family)
            if cycle:
                _REG.violations.append(
                    {
                        "kind": "lock-order-cycle",
                        "msg": "lock-order cycle "
                        + " -> ".join(cycle)
                        + f" (new edge {other.name} -> {self.name})",
                        "thread": threading.current_thread().name,
                    }
                )

    # -- lock protocol -----------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _REG.enabled:
            self._check_acquire()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held = _held()
            n = held.get(self, 0)
            held[self] = n + 1
            if n == 0:  # outermost acquire: hold starts now
                _hold_t0()[self] = time.monotonic_ns()
        return ok

    def release(self) -> None:
        self._inner.release()
        held = _held()
        n = held.get(self, 0) - 1
        if n <= 0:
            held.pop(self, None)
            t0 = _hold_t0().pop(self, None)
            if t0 is not None:
                _record_hold(self, time.monotonic_ns() - t0)
        else:
            held[self] = n

    __enter__ = acquire

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    # -- Condition integration ----------------------------------------------
    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        # Called exactly when a Condition.wait() is about to block: the
        # thread parks with this lock released — anything *else* still
        # held blocks every other acquirer for the whole wait.
        if _REG.enabled:
            allowed = _WAIT_ALLOWED.get(self.family, frozenset())
            others = [
                lk.name
                for lk in _held()
                if lk is not self and lk.family not in allowed
            ]
            if others:
                _record(
                    "wait-under-lock",
                    f"condition wait on {self.name} while holding {others}",
                )
        count = _held().pop(self, 0)
        # The wait releases this lock: close out the hold now so parked
        # time is not billed as held time.
        t0 = _hold_t0().pop(self, None)
        if t0 is not None:
            _record_hold(self, time.monotonic_ns() - t0)
        return (self._inner._release_save(), count)

    def _acquire_restore(self, state) -> None:
        inner_state, count = state
        self._inner._acquire_restore(inner_state)
        if count:
            _held()[self] = count
            _hold_t0()[self] = time.monotonic_ns()

    def held_by_current_thread(self) -> bool:
        return self in _held()


def make_lock(name: str):
    """The repo's lock factory: tracked when the detector is on, plain RLock
    otherwise (zero overhead in production)."""
    if _REG.enabled:
        return TrackedRLock(name)
    return threading.RLock()


def _report_at_exit() -> None:
    vs = violations()
    if vs:
        print(
            f"REPRO_LOCK_CHECK: {len(vs)} concurrency violation(s) detected:",
            file=sys.stderr,
        )
        for v in vs:
            print(f"  [{v['kind']}] ({v['thread']}) {v['msg']}", file=sys.stderr)
    stats = hold_stats()
    if stats:
        top = sorted(stats.items(), key=lambda kv: kv[1]["max_ns"], reverse=True)
        print("REPRO_LOCK_CHECK: lock hold times (top families by max):", file=sys.stderr)
        for fam, st in top[:8]:
            print(
                f"  {fam:12s} holds={st['count']:<8d}"
                f" mean={st['mean_ns'] / 1e3:8.1f}us"
                f" max={st['max_ns'] / 1e3:10.1f}us ({st['max_lock']})",
                file=sys.stderr,
            )
    warns = hold_warnings()
    if warns:
        print(
            f"REPRO_LOCK_CHECK: {len(warns)} hold(s) exceeded the warn"
            f" threshold ({_REG.hold_warn_ns / 1e6:.0f}ms):",
            file=sys.stderr,
        )
        for w in warns[:10]:
            print(
                f"  {w['lock']} held {w['held_ns'] / 1e6:.1f}ms ({w['thread']})",
                file=sys.stderr,
            )


if _REG.enabled:  # pragma: no cover - exercised via REPRO_LOCK_CHECK=1 runs
    atexit.register(_report_at_exit)
