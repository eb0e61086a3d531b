"""CFS metadata on the broker, trimmed from ``CFSExtension`` of the
reference's ``repro/core/fs.py``.

The broker keeps only metadata: file revisions under labels, and
snapshots that pin the head revisions of a label's subtree. The bytes
live in a blob store that the executors reach on their own
(``core.fs.CFSClient``).
"""

from __future__ import annotations

import os
import secrets
from typing import Any, Callable

from ..core.errors import NotFoundError, ValidationError
from ..core.process import now_ns


def _norm_label(label: str) -> str:
    if not label.startswith("/"):
        label = "/" + label
    return label.rstrip("/") or "/"


class CFSExtension:
    def __init__(self, server) -> None:
        self.server = server
        self.db = server.db
        server.extensions.append(self)

    def handlers(self) -> dict[str, Callable[[str, dict], Any]]:
        return {
            "addfile": self._h_add_file,
            "getfile": self._h_get_file,
            "getfiles": self._h_get_files,
            "removefile": self._h_remove_file,
            "createsnapshot": self._h_create_snapshot,
            "getsnapshot": self._h_get_snapshot,
            "getsnapshots": self._h_get_snapshots,
            "removesnapshot": self._h_remove_snapshot,
        }

    def tick(self) -> None:  # no periodic work
        pass

    def _h_add_file(self, identity: str, payload: dict) -> dict:
        f = payload["file"]
        colony = f.get("colonyname", "")
        self.server._require_member(identity, colony)
        name = f.get("name", "")
        if not name:
            raise ValidationError("file needs a name")
        if name in (".", "..") or "/" in name or "\\" in name or os.sep in name:
            raise ValidationError(f"file name {name!r} must be a single path component"
                                  " (no separators, no '.'/'..')")
        if not f.get("checksum"):
            raise ValidationError("file needs a checksum (immutability contract)")
        # metadata must point at bytes that a later download can resolve
        storage = f.get("storage")
        if not isinstance(storage, dict) or not storage.get("backend") or not storage.get("url"):
            raise ValidationError("file needs a storage reference {'backend': ..., 'url': ...}")
        if not isinstance(storage["backend"], str) or not isinstance(storage["url"], str):
            raise ValidationError("storage backend and url must be strings")
        entry = {
            "fileid": secrets.token_hex(16),
            "colonyname": colony,
            "label": _norm_label(f.get("label", "/")),
            "name": name,
            "size": int(f.get("size", 0)),
            "checksum": f["checksum"],
            "storage": dict(storage),
            "added": now_ns(),
            "addedby": identity,
        }
        return self.db.cfs_add_file(entry)  # revision = head + 1

    def _h_get_file(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        if "fileid" in payload:
            e = self.db.cfs_get_file(colony, payload["fileid"])
            if e is None:
                raise NotFoundError("file not found")
            return e
        label = _norm_label(payload["label"])
        e = self.db.cfs_head(colony, label, payload["name"])
        if e is None:
            raise NotFoundError(f"file {label}/{payload['name']} not found")
        return e

    def _h_get_files(self, identity: str, payload: dict) -> list[dict]:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        return self.db.cfs_list(colony, _norm_label(payload["label"]))

    def _h_remove_file(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        fileid = payload["fileid"]
        # a revision pinned by a snapshot raises ConflictError
        if self.db.cfs_remove_file(colony, fileid) is None:
            raise NotFoundError("file not found")
        return {"fileid": fileid, "removed": True}

    def _h_create_snapshot(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        return self.db.cfs_create_snapshot({
            "snapshotid": secrets.token_hex(16),
            "colonyname": colony,
            "name": payload.get("name", ""),
            "label": _norm_label(payload["label"]),
            "added": now_ns(),
        })

    def _h_get_snapshot(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        s = self.db.cfs_get_snapshot(colony, payload["snapshotid"])
        if s is None:
            raise NotFoundError("snapshot not found")
        files, missing = [], []
        for fid, e in zip(s["fileids"], self.db.cfs_get_files_by_ids(colony, s["fileids"])):
            (files.append(e) if e is not None else missing.append(fid))
        s["files"] = files
        if missing:
            s["missing"] = missing
        return s

    def _h_get_snapshots(self, identity: str, payload: dict) -> list[dict]:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        return self.db.cfs_list_snapshots(colony)

    def _h_remove_snapshot(self, identity: str, payload: dict) -> dict:
        colony = payload["colonyname"]
        self.server._require_member(identity, colony)
        sid = payload["snapshotid"]
        if self.db.cfs_remove_snapshot(colony, sid) is None:
            raise NotFoundError("snapshot not found")
        return {"snapshotid": sid, "removed": True}
