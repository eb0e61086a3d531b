"""The client side of ColonyOS, copied from the reference's ``repro.core``.

What an executor needs to join a colony: signed identities (``crypto``),
signed envelopes (``security``), the idempotency table (``idempotency``),
function and workflow specs (``spec``), processes (``process``), the SDK
client and its transports (``client``, ``http_transport``), CFS storage
and its client (``fs``), retries (``retry``), errors (``errors``) and the
executor loop (``executor``). Each module repeats its reference namesake;
the broker (server, database, consensus, generators, cron) is not copied:
an executor reaches it only through the signed JSON protocol.
"""

from .client import Colonies, InProcTransport
from .crypto import Crypto
from .executor import ExecutorBase, ProcessContext
from .http_transport import HttpTransport
from .retry import RetryPolicy
from .spec import FunctionSpec, WorkflowSpec

__all__ = [
    "Colonies",
    "Crypto",
    "ExecutorBase",
    "FunctionSpec",
    "HttpTransport",
    "InProcTransport",
    "ProcessContext",
    "RetryPolicy",
    "WorkflowSpec",
]
