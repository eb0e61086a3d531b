"""Concurrency-, authorization- and replication-contract analysis for
the port's broker: a copy of the reference's ``repro/analysis``, stdlib
only, module for module, with the same switches (``REPRO_LOCK_CHECK``,
``REPRO_AUTH_CHECK``, ``REPRO_REPL_CHECK``) and the same lint rules.

Three contract planes, each with a runtime detector and a static lint
(TORCH_CONTRACTS.md says how the port applies them):

Concurrency:

* :mod:`repro_torch.analysis.locktrack` — a runtime lock-order detector.
  ``make_lock(name)`` hands out plain ``threading.RLock`` objects unless
  ``REPRO_LOCK_CHECK=1`` (or :func:`locktrack.enable`), in which case it
  returns :class:`TrackedRLock` instances that record per-thread held-lock
  sets, build the global lock-order graph, report cycles, acquisition
  under a leaf lock (``_glock``), cross-shard nesting, and condition-waits
  entered while holding other locks — and record per-family lock
  hold-time stats (max/mean, long-hold warnings).
* :mod:`repro_torch.analysis.contracts` — ``@requires_lock("shard")`` /
  ``@no_locks_held(...)`` decorators turning "called with the shard lock
  held" into runtime-checked declarations.
* :mod:`repro_torch.analysis.lint` — ``python -m
  repro_torch.analysis.lint``, a stdlib-``ast`` static pass enforcing the
  broker's concurrency and hygiene rules (LNT001–LNT005).

Authorization:

* :mod:`repro_torch.analysis.authtrack` — runtime auth-fact contracts
  behind ``REPRO_AUTH_CHECK=1``: the server records each verified
  ``(identity, colony, role)``; colony-scoped ``Database`` entry points
  and ``@requires_auth(role)``-decorated internals raise
  :class:`AuthContractError` when no matching fact was recorded.
* :mod:`repro_torch.analysis.authlint` — ``python -m
  repro_torch.analysis.authlint``, an interprocedural pass proving every
  registered RPC handler authorizes before touching the database
  (AUT001–AUT004).
* :mod:`repro_torch.analysis.authmap` — ``python -m
  repro_torch.analysis.authmap``, which generates the payloadtype →
  required-role permission matrix in TORCH_CONTRACTS.md (``--check``
  gates drift).

Replication:

* :mod:`repro_torch.analysis.statehash` — runtime divergence contracts
  behind ``REPRO_REPL_CHECK=1``: incremental per-colony state digests,
  chained per-node apply journals cross-checked at each Raft index
  (:class:`ReplicationDivergenceError` on the first disagreement), and
  the double-apply idempotence harness in ``HAColonyCluster._apply``.
* :mod:`repro_torch.analysis.replint` — ``python -m
  repro_torch.analysis.replint``, an interprocedural pass proving the
  apply cone of every replicated op deterministic and CAS-guarded
  (REP001–REP005).
* :mod:`repro_torch.analysis.replmap` — ``python -m
  repro_torch.analysis.replmap``, which generates the replicated-op
  matrix (op → required fields, leader-stamped fields, CAS guard) in
  TORCH_CONTRACTS.md (``--check`` gates drift).

Idempotency: :mod:`repro_torch.analysis.idemlint` — ``python -m
repro_torch.analysis.idemlint`` proves ``core/idempotency.py``'s SPEC
matches the handler tables (IDM001–IDM004).
"""

from .authtrack import AuthContractError, requires_auth
from .contracts import LockContractError, no_locks_held, requires_lock
from .locktrack import (
    TrackedRLock,
    enable,
    hold_stats,
    hold_warnings,
    is_enabled,
    make_lock,
    reset,
    set_hold_warn_ms,
    violations,
)
from .statehash import (
    ClusterJournal,
    ColonyDigest,
    ReplicationDivergenceError,
    entry_digest,
    full_colony_digest,
    process_state_tuple,
)

__all__ = [
    "AuthContractError",
    "ClusterJournal",
    "ColonyDigest",
    "LockContractError",
    "ReplicationDivergenceError",
    "TrackedRLock",
    "entry_digest",
    "full_colony_digest",
    "process_state_tuple",
    "enable",
    "hold_stats",
    "hold_warnings",
    "is_enabled",
    "make_lock",
    "no_locks_held",
    "requires_auth",
    "requires_lock",
    "reset",
    "set_hold_warn_ms",
    "violations",
]
