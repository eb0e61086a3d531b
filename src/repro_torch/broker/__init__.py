"""The broker side of ColonyOS, copied from the reference's ``repro.core``
(``server``, ``database``, ``generator``, ``cron``, ``raft``,
``cluster``, the metadata half of ``fs``, the server half of
``http_transport``), checked by the port's analysis plane
(``repro_torch.analysis``): the indexed in-memory database or the sqlite
one, a file that outlives the broker process (§3.4.3), under one replica
(``standalone_server``) or several behind Raft (``HAColonyCluster``,
paper §3.4.1, Fig. 3).

ColonyOS deploys the broker as a service of its own, which executors
reach only through the signed JSON protocol. This package imports the
standard library and the stdlib modules ``repro_torch.core``,
``repro_torch.analysis`` and ``repro_torch.runtime.faults``, never
torch, so that ``chip_smoke.py`` can run it as a separate process beside
the executors on the card::

    srv = standalone_server(server_id)  # or (server_id, SqliteDatabase(path))
    http = ColoniesHttpServer(srv)
    http.start()
    srv.start_background(failsafe_interval=0.1)

A broker over a ``SqliteDatabase`` file can be killed at any moment and
started again over the same file: the queue, the leases, CFS metadata,
cron and generator tables, pending packs and the dedup records are rows
of that file, and no session state lives in memory.

or, replicated::

    cluster = HAColonyCluster(server_id, replicas=3, seed=0)
    https = [ColoniesHttpServer(s) for s in cluster.servers]
    cluster.start(failsafe_interval=0.1)
"""

from .cfs import CFSExtension
from .cluster import HAColonyCluster
from .cron import CronExtension
from .database import Database, MemoryDatabase, SqliteDatabase
from .generator import GeneratorExtension
from .http_server import ColoniesHttpServer
from .server import ColoniesServer


def standalone_server(serverid: str, db: Database | None = None) -> ColoniesServer:
    """One broker with cron, generators and CFS metadata wired, over
    ``db`` (a fresh ``MemoryDatabase`` when None)."""
    srv = ColoniesServer(serverid, db)
    CronExtension(srv)
    GeneratorExtension(srv)
    CFSExtension(srv)
    return srv


__all__ = ["ColoniesHttpServer", "ColoniesServer", "Database", "HAColonyCluster",
           "MemoryDatabase", "SqliteDatabase", "standalone_server"]
