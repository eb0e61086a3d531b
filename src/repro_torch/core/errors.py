"""Error types for the ColonyOS core.

A copy of the reference's ``repro/core/errors.py``, with the same HTTP
status of each error: the port speaks the same protocol.
"""


class ColoniesError(Exception):
    """Base error for all colony operations."""

    status = 500


class AuthError(ColoniesError):
    """Signature invalid or identity not authorized for the operation."""

    status = 403


class NotFoundError(ColoniesError):
    """Referenced entity does not exist."""

    status = 404


class ConflictError(ColoniesError):
    """Write conflicted with the current state (e.g. double close)."""

    status = 409


class TimeoutError_(ColoniesError):
    """Long-poll assign expired without a matching process."""

    status = 408


class NotLeaderError(ColoniesError):
    """Synchronized request hit a follower replica; retry against leader."""

    status = 421

    def __init__(self, msg: str = "not leader", leader: str | None = None):
        super().__init__(msg)
        self.leader = leader


class ValidationError(ColoniesError):
    """Malformed function spec / workflow / request payload."""

    status = 400


class TransportError(ColoniesError):
    """Request never produced a server reply (refused/reset/timed out).

    The mutation may or may not have committed server-side — safe to
    retry only because mutating RPCs carry an idempotency key (msgid)."""

    status = 503
