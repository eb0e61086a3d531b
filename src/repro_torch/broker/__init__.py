"""The broker side of ColonyOS, copied from the reference's ``repro.core``
(``server``, ``database``, ``generator``, the metadata half of ``fs``,
the server half of ``http_transport``) and trimmed to what the port's
executors and client use: one replica, an in-memory database, no cron.

ColonyOS deploys the broker as a service of its own, which executors
reach only through the signed JSON protocol. This package imports the
standard library and ``repro_torch.core``, never torch, so that
``chip_smoke.py`` can run it as a separate process beside the executors
on the card::

    srv = standalone_server(server_id)
    http = ColoniesHttpServer(srv)
    http.start()
    srv.start_background(failsafe_interval=0.1)
"""

from .cfs import CFSExtension
from .generator import GeneratorExtension
from .http_server import ColoniesHttpServer
from .server import ColoniesServer


def standalone_server(serverid: str) -> ColoniesServer:
    """One broker with generators and CFS metadata wired."""
    srv = ColoniesServer(serverid)
    GeneratorExtension(srv)
    CFSExtension(srv)
    return srv


__all__ = ["ColoniesHttpServer", "ColoniesServer", "standalone_server"]
