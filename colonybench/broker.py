"""The port's broker in a process of its own, reached over HTTP.

ColonyOS deploys the broker as a service that executors and clients reach
only through the signed JSON protocol, so the benchmark runs the port's
broker (``repro_torch.broker``: the indexed ``MemoryDatabase``, every
signature verified, the failsafe scan and the generators' ticks every
0.1 s) as a child process. The child registers the ``repro_torch``
package by its path without running its ``__init__``, so it loads no
torch. Adapted from ``chip_smoke.py``'s ``BROKER_SOURCE``, without the
runtime lock and auth detectors, which a deployment runs without.
"""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

SOURCE = """\
import json, sys, threading, types
pkg = types.ModuleType("repro_torch")
pkg.__path__ = [sys.argv[2]]
sys.modules["repro_torch"] = pkg
from repro_torch.broker import ColoniesHttpServer, MemoryDatabase, standalone_server
srv = standalone_server(sys.argv[1], MemoryDatabase())
http = ColoniesHttpServer(srv, port=0)
http.start()
srv.start_background(failsafe_interval=0.1)
tops = sorted({n.split(".")[0] for n in sys.modules} & {"torch", "jax", "jaxlib", "repro"})
print(json.dumps({"port": http.port, "loaded": tops}), flush=True)
sys.stdin.read()
"""


def register_package(src: Path) -> None:
    """Make ``repro_torch``'s stdlib modules importable in this process
    without its ``__init__`` (which imports torch)."""
    if "repro_torch" not in sys.modules:
        pkg = types.ModuleType("repro_torch")
        pkg.__path__ = [str(src / "repro_torch")]
        sys.modules["repro_torch"] = pkg


class BrokerProcess:
    """The broker child, its port and a signed client to it. The child
    ends when its stdin closes (``close``) or is killed."""

    def __init__(self, src: Path, server_id: str) -> None:
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SOURCE, server_id, str(src / "repro_torch")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line:
            self.close()
            raise RuntimeError("the broker process ended before printing its port")
        info = json.loads(line)
        if info["loaded"]:
            self.close()
            raise RuntimeError(f"the broker process loaded {info['loaded']}")
        self.port = info["port"]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        for pipe in (self.proc.stdin, self.proc.stdout):
            if pipe and not pipe.closed:
                pipe.close()
