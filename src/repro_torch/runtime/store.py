"""An in-memory CFS for the port's handlers, launchers and checkpoints.

The four members the handlers and ``train.checkpoint.CheckpointManager``
call on the reference's ``CFSClient``, with nothing behind them but a
dict: the store the CLIs and the card's smoke run use while the broker
side is not ported (ROADMAP A8).
"""

from __future__ import annotations

import itertools


class MemoryStore:
    """In-memory CFS with the four members the handlers and the checkpoint
    manager call. Files are immutable revisions; a snapshot pins the
    revisions a label holds when it is taken."""

    def __init__(self, prvkey: str = "memory-store") -> None:
        self.files: dict[tuple[str, str, str], bytes] = {}
        self.snapshots: dict[str, dict] = {}
        self.client = self  # ``cfs.client.create_snapshot`` as on a CFSClient
        self.prvkey = prvkey
        self._ids = itertools.count()

    def upload_bytes(self, colony: str, label: str, name: str, data: bytes) -> dict:
        self.files[(colony, label, name)] = bytes(data)
        return {"fileid": f"file-{next(self._ids):08d}", "label": label, "name": name,
                "size": len(data)}

    def download_bytes(self, colony: str, label: str, name: str) -> bytes:
        try:
            return self.files[(colony, label, name)]
        except KeyError:
            raise FileNotFoundError(f"{colony}:{label}/{name}") from None

    def create_snapshot(self, colony: str, label: str, name: str, prvkey: str) -> dict:
        files = {n: data for (c, lab, n), data in self.files.items() if c == colony and lab == label}
        snap = {"snapshotid": f"snap-{next(self._ids):08d}", "colonyname": colony, "label": label,
                "name": name, "files": files}
        self.snapshots[snap["snapshotid"]] = snap
        return snap
