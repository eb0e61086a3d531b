"""Runtime auth-fact contracts (the dynamic half of the authorization lint).

A copy of the reference's ``repro/analysis/authtrack.py``, with the same
``REPRO_AUTH_CHECK`` switch and the same guarded database methods.

The zero-trust protocol (paper §3.4.6) is only as strong as the weakest
`_h_*` handler: each one must call `_require_member` / owner / executor
checks before touching the database, and nothing at runtime used to
verify that it did. This module turns the verified identity into an
explicit **auth fact** and makes colony-scoped database access refuse to
run without one — so a future handler that forgets its check fails hard
in CI instead of silently bypassing authorization.

Mechanics, mirroring :mod:`repro_torch.analysis.locktrack`:

* Disabled (the default), everything here is a cheap flag check — no
  context is created and no fact is recorded. Enabled via
  ``REPRO_AUTH_CHECK=1`` or :func:`enable`:
* :func:`request_scope` — entered by ``ColoniesServer.handle`` around
  handler dispatch. Inside a scope the fact set starts empty; outside a
  scope (background failsafe/cron/generator ticks, Raft applies, direct
  database use in tests and benchmarks) the guards are inert, because
  those paths have no request identity to verify.
* :func:`record` — called by the server's ``_require_*`` helpers after a
  check passes, recording ``(identity, colony, role)`` in the
  request-scoped context (a ``contextvars.ContextVar``, so concurrent
  long-poll requests on different threads never share facts).
* :func:`check_colony` — invoked by the colony-scoped ``Database`` entry
  points (wired up in ``Database.__init_subclass__``): inside a request
  scope, touching colony X's rows without a recorded fact for X raises
  :class:`AuthContractError`.
* :func:`requires_auth` — decorator for handler internals
  (``close_process``, ``submit_workflow_processes``): entering one inside
  a request scope without a fact of (at least) the declared role raises.

Roles form the paper's Table 5 lattice: ``server`` (server owner,
recorded with the wildcard colony ``"*"``) satisfies everything,
``owner`` satisfies ``member``, ``executor`` satisfies ``member``, and
``member`` is the floor. Contract violations *raise* (like
contracts.py, unlike the lock detector): they guard single well-defined
boundaries where an exception is a correct hard failure.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
from typing import Callable

#: roles that satisfy a requirement for the key role
ROLE_SATISFIED_BY = {
    "member": frozenset({"member", "executor", "owner", "server"}),
    "executor": frozenset({"executor", "server"}),
    "owner": frozenset({"owner", "server"}),
    "server": frozenset({"server"}),
}

#: the wildcard colony recorded by a server-owner fact
ANY_COLONY = "*"


class AuthContractError(AssertionError):
    """A database access or handler internal ran without a matching
    recorded auth fact — a missed/bypassed authorization check."""


class _Registry:
    def __init__(self) -> None:
        self.enabled = os.environ.get("REPRO_AUTH_CHECK", "") not in ("", "0")


_REG = _Registry()

# The facts for the current request: a tuple of (identity, colony, role).
# None = not inside a request scope (guards inert).
_FACTS: contextvars.ContextVar[tuple | None] = contextvars.ContextVar(
    "repro_auth_facts", default=None
)


def is_enabled() -> bool:
    return _REG.enabled


def enable(on: bool = True) -> None:
    """Toggle checking at runtime (tests)."""
    _REG.enabled = on


def in_request() -> bool:
    """True when the current context is inside a handler dispatch."""
    return _REG.enabled and _FACTS.get() is not None


def facts() -> tuple:
    """The current request's recorded facts (empty outside a scope)."""
    return _FACTS.get() or ()


@contextlib.contextmanager
def request_scope():
    """Mark handler dispatch: facts start empty, guards become active."""
    if not _REG.enabled:
        yield
        return
    token = _FACTS.set(())
    try:
        yield
    finally:
        _FACTS.reset(token)


def record(identity: str, colony: str, role: str) -> None:
    """Record a verified (identity, colony, role) fact for this request.

    Called by the server's ``_require_*`` helpers immediately after the
    check passes. Outside a request scope (or disabled) this is a no-op.
    """
    if not _REG.enabled:
        return
    cur = _FACTS.get()
    if cur is None:
        return
    fact = (identity, colony, role)
    if fact not in cur:
        _FACTS.set(cur + (fact,))


def has_fact(colony: str | None = None, role: str = "member") -> bool:
    """Does the current request hold a fact for ``colony`` at ``role``?

    ``colony=None`` checks role only; a ``server`` fact (colony ``"*"``)
    matches any colony.
    """
    ok_roles = ROLE_SATISFIED_BY[role]
    for _ident, fcolony, frole in _FACTS.get() or ():
        if frole not in ok_roles:
            continue
        if colony is None or fcolony == colony or fcolony == ANY_COLONY:
            return True
    return False


def check_colony(method: str, colony: str) -> None:
    """Guard for colony-scoped Database entry points.

    Active only inside a request scope: raises unless the request
    recorded an auth fact for ``colony`` (any role — role placement is
    the handler's job, enforced by authlint + :func:`requires_auth`).
    """
    cur = _FACTS.get()
    if cur is None:
        return
    if has_fact(colony):
        return
    raise AuthContractError(
        f"Database.{method} touched colony {colony!r} with no recorded auth"
        f" fact for it (facts: {[(c, r) for _i, c, r in cur]}) — a handler"
        " skipped its _require_* check (see TORCH_CONTRACTS.md)"
    )


def requires_auth(role: str = "member") -> Callable:
    """Declare that a handler internal runs only after a ``role`` fact.

    Inert outside request scopes (leader ticks, failsafe, Raft applies
    legitimately run these functions with no request identity).
    """
    if role not in ROLE_SATISFIED_BY:
        raise ValueError(f"unknown auth role {role!r}")

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _REG.enabled and _FACTS.get() is not None and not has_fact(None, role):
                raise AuthContractError(
                    f"{fn.__qualname__} requires a recorded {role!r} auth fact"
                    f" (facts: {[(c, r) for _i, c, r in _FACTS.get() or ()]})"
                )
            return fn(*args, **kwargs)

        wrapper.__auth_contract__ = role
        return wrapper

    return deco


# ---------------------------------------------------------------------------
# Database wiring
# ---------------------------------------------------------------------------

# Colony-scoped Database entry points and how to pull the colony out of
# their positional args (index past self). "attr"/"key" reach into the
# Process/Executor object or entry dict those methods take. Id-keyed
# fetches (get_process, get_executor, cron_get, user_get, kv_get, ...)
# are deliberately absent: they are the allowed "fetch" half of the
# fetch-then-authorize pattern (authlint AUT004 polices their ordering).
GUARDED_DB_METHODS: dict[str, tuple] = {
    # colony string in positional args
    "list_executors": ("arg", 0),
    "list_functions": ("arg", 0),
    "add_function": ("arg", 1),
    "list_processes": ("arg", 0),
    "candidates": ("arg", 0),
    "colony_stats": ("arg", 0),
    "user_list": ("arg", 0),
    "cfs_get_file": ("arg", 0),
    "cfs_get_files_by_ids": ("arg", 0),
    "cfs_head": ("arg", 0),
    "cfs_list": ("arg", 0),
    "cfs_remove_file": ("arg", 0),
    "cfs_pin_count": ("arg", 0),
    "cfs_get_snapshot": ("arg", 0),
    "cfs_list_snapshots": ("arg", 0),
    "cfs_remove_snapshot": ("arg", 0),
    "cron_list": ("arg", 0),
    "generator_list": ("arg", 0),
    # colony on an object attribute
    "add_process": ("attr", 0, "colonyname"),
    "update_process": ("attr", 0, "colonyname"),
    "requeue": ("attr", 0, "colonyname"),
    "add_executor": ("attr", 0, "colonyname"),
    "add_colony": ("attr", 0, "colonyname"),
    # colony under a dict key
    "cfs_add_file": ("key", 0, "colonyname"),
    "cfs_create_snapshot": ("key", 0, "colonyname"),
    "cron_put": ("key", 0, "colonyname"),
    "generator_put": ("key", 0, "colonyname"),
    "user_put": ("key", 0, "colonyname"),
}


def _extract_colony(spec: tuple, args: tuple) -> str | None:
    kind, idx = spec[0], spec[1]
    if idx >= len(args):
        return None  # kwargs-only call: nothing to check against
    val = args[idx]
    if kind == "arg":
        return val if isinstance(val, str) else None
    if kind == "attr":
        return getattr(val, spec[2], None)
    if kind == "key":
        try:
            return val.get(spec[2])
        except AttributeError:
            return None
    return None


def guard_db_method(name: str, fn: Callable) -> Callable:
    """Wrap one Database entry point with the colony auth-fact guard."""
    spec = GUARDED_DB_METHODS[name]

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if _REG.enabled and _FACTS.get() is not None:
            colony = _extract_colony(spec, args)
            if colony:
                check_colony(name, colony)
        return fn(self, *args, **kwargs)

    wrapper.__auth_guarded__ = True
    return wrapper


def guard_database_subclass(cls) -> None:
    """Called from ``Database.__init_subclass__``: wrap every guarded
    entry point the subclass defines (inherited wrappers stay wrapped)."""
    for name in GUARDED_DB_METHODS:
        fn = cls.__dict__.get(name)
        if fn is None or getattr(fn, "__auth_guarded__", False):
            continue
        setattr(cls, name, guard_db_method(name, fn))
