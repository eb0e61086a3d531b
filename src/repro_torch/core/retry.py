"""Retry policy for RPC transports (ROBUSTNESS.md).

A copy of the reference's ``repro/core/retry.py``.

Capped exponential backoff with decorrelated jitter (each delay is drawn
from ``uniform(base, prev * 3)`` and capped), bounded by both a retry
budget (max attempts) and an overall wall-clock deadline. Retries are
safe because every mutating RPC carries an idempotency key (``msgid``,
see idempotency.py): at-least-once delivery + server-side dedup =
exactly-once effect.

Only *transport-level* failures are retried — status 503 (connection
refused/reset/timed out, surfaced by the transports as a synthetic error
dict) and 421 (follower replica; the transports already rotate hosts
within a pass, the policy retries the whole pass so a mid-election
cluster converges). Application errors (400/403/404/408/409) mean the
server heard us and answered; retrying those is the caller's business.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable

RETRYABLE_STATUSES = frozenset({503, 421})


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff + decorrelated jitter.

    ``budget`` counts total send attempts (1 = no retries). ``deadline_s``
    bounds the whole operation including sleeps; whichever of budget or
    deadline trips first ends the retry loop and the last error is
    returned to the caller. ``seed`` pins the jitter RNG for
    deterministic tests (None = nondeterministic, fine in production).
    """

    base_s: float = 0.02
    cap_s: float = 1.0
    deadline_s: float = 30.0
    budget: int = 8
    seed: int | None = None

    def delays(self) -> "_DelayIter":
        return _DelayIter(self)


class _DelayIter:
    """Stateful decorrelated-jitter delay sequence (AWS architecture blog)."""

    def __init__(self, policy: RetryPolicy) -> None:
        self.policy = policy
        self.rng = random.Random(policy.seed)
        self._prev = policy.base_s

    def next_delay(self) -> float:
        self._prev = min(self.policy.cap_s, self.rng.uniform(self.policy.base_s, self._prev * 3))
        return self._prev


def send_with_retry(attempt: Callable[[], dict], policy: RetryPolicy | None) -> dict:
    """Drive ``attempt`` (one full transport pass) under ``policy``.

    ``attempt`` returns the protocol reply dict; it is retried while the
    reply is an error with a status in RETRYABLE_STATUSES, until the
    budget or deadline runs out. The last reply (success or error) is
    returned — raising is the SDK layer's job.
    """
    if policy is None:
        return attempt()
    deadline = time.monotonic() + policy.deadline_s
    delays = policy.delays()
    resp: dict = {"error": "retry budget is zero", "status": 503}
    for i in range(max(1, policy.budget)):
        resp = attempt()
        if "error" not in resp or int(resp.get("status", 500)) not in RETRYABLE_STATUSES:
            return resp
        if i + 1 >= max(1, policy.budget):
            break
        delay = delays.next_delay()
        if time.monotonic() + delay >= deadline:
            break
        time.sleep(delay)
    return resp
