"""Declared lock contracts — the static half of "called with the lock held".

A copy of the reference's ``repro/analysis/contracts.py``.
``@requires_lock("shard")`` replaces a comment-contract ("called with
the shard lock held") with a declaration that is

* **asserted at runtime** when the detector is enabled (REPRO_LOCK_CHECK=1
  or :func:`repro_torch.analysis.locktrack.enable`): entering the function on a
  thread that does not hold the named lock raises
  :class:`LockContractError`;
* **checked statically** by ``python -m repro_torch.analysis.lint``: every
  database method that takes a shard parameter must carry one.

``@no_locks_held(...)`` is the dual: the function blocks (long-poll wait,
Raft commit wait, failsafe scan) and must not be entered while holding
the named lock families — with no families given, while holding *any*
tracked lock. This encodes the broker's first deadlock fix as a contract: a Raft
proposal must never happen under a database lock, because the commit is
applied on another thread that needs those same locks.

Disabled, both decorators cost one attribute load and branch per call —
the wrapped function is otherwise a pass-through.
"""

from __future__ import annotations

import functools
from typing import Callable

from . import locktrack
from .locktrack import TrackedRLock, _REG, _held

# Attributes probed (in order) on each positional argument to find the
# lock instance a contract refers to: shard objects expose ``.lock``,
# databases expose ``._glock`` / ``._lock``.
_LOCK_ATTRS = ("lock", "_glock", "_lock")


class LockContractError(AssertionError):
    """A function's declared lock contract was violated at runtime."""


def _locate(family: str, args: tuple) -> TrackedRLock | None:
    for a in args:
        for attr in _LOCK_ATTRS:
            lk = getattr(a, attr, None)
            if isinstance(lk, TrackedRLock) and lk.family == family:
                return lk
    return None


def requires_lock(
    family: str, getter: Callable[..., object] | None = None
) -> Callable:
    """Declare that the decorated function runs with a ``family`` lock held.

    The lock instance is found by scanning the positional arguments for an
    object whose ``.lock`` / ``._glock`` / ``._lock`` is a tracked lock of
    that family (shard methods receive the shard; sqlite methods receive
    ``self``), or via an explicit ``getter(*args, **kwargs)``. Objects
    created while the detector was off carry plain RLocks and are skipped
    — the contract only binds where it can be checked.
    """

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _REG.enabled:
                lk = getter(*args, **kwargs) if getter is not None else _locate(family, args)
                if isinstance(lk, TrackedRLock) and lk not in _held():
                    raise LockContractError(
                        f"{fn.__qualname__} requires {lk.name} held"
                        f" (declared @requires_lock({family!r}))"
                    )
            return fn(*args, **kwargs)

        wrapper.__lock_contract__ = ("requires", family)
        return wrapper

    return deco


def no_locks_held(*families: str) -> Callable:
    """Declare that the decorated (blocking) function must be entered with
    no tracked locks of the given families held — or none at all when
    called as ``@no_locks_held()``."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _REG.enabled:
                bad = [
                    lk.name
                    for lk in _held()
                    if not families or lk.family in families
                ]
                if bad:
                    raise LockContractError(
                        f"{fn.__qualname__} may block but was entered holding {bad}"
                        f" (declared @no_locks_held{families or ''})"
                    )
            return fn(*args, **kwargs)

        wrapper.__lock_contract__ = ("forbids", families)
        return wrapper

    return deco


# Re-exported for convenience so call sites import one module.
enable = locktrack.enable
is_enabled = locktrack.is_enabled
