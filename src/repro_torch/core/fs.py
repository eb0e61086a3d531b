"""CFS — the Colony FileSystem (paper §3.4.5), the executor's half.

A copy of the client half of the reference's ``repro/core/fs.py``: the
content-addressed storage backends (``MemoryStorage``, ``LocalStorage``)
and ``CFSClient``, which pairs the broker's metadata RPCs with a
storage's bytes. The broker's metadata handlers (``CFSExtension``) live
in ``broker/cfs.py``; the sharded, self-healing store over these
backends is ``core/blobstore.py``'s ``ShardedStorage``. ``CFSClient``
takes any object with ``scheme``, ``put`` and ``get``.

Invariants, as the paper argues:
  * **Immutability** — a file revision is never altered; re-adding the
    same (label, name) creates a new revision.
  * **Snapshots** — immutable pins of a whole label tree (directory), so
    queued processes see frozen inputs no matter how long they wait.
  * **Sync directives** — function specs carry ``fs.snapshots``/``fs.dirs``
    blocks; executors materialize them before execution and upload
    results after (see runtime/torch_executor.py).
"""

from __future__ import annotations

import hashlib
import os
import secrets
import time
from typing import Any, Callable

from ..analysis.locktrack import make_lock
from .errors import ConflictError, NotFoundError, TransportError, ValidationError
from .retry import RetryPolicy


def checksum(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _write_atomic(path: str, data: bytes) -> None:
    """Crash-safe destination write: tmp + ``os.replace``, so a crash
    mid-write can never leave a torn file under the final name (the same
    contract ``LocalStorage.put`` already keeps for blobs)."""
    tmp = path + f".tmp{secrets.token_hex(4)}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# ---------------------------------------------------------------------------
# Storage backends (the bytes plane)
# ---------------------------------------------------------------------------


class Storage:
    """Content-addressed blob store.

    The content-address contract cuts both ways: ``put`` derives the key
    from the bytes, and ``get`` re-verifies ``checksum(data) == key`` so
    a blob corrupted at rest raises ``ConflictError`` instead of
    silently propagating garbage (and so a sharded store can rotate to a
    healthy replica and read-repair the bad copy — see the reference's blobstore.py).
    """

    scheme = "abstract"

    def put(self, data: bytes) -> str:
        """Store bytes, return an URL."""
        raise NotImplementedError

    def get(self, url: str) -> bytes:
        raise NotImplementedError

    def keys(self) -> list[str]:
        """All stored content-address keys (for scrub/anti-entropy)."""
        raise NotImplementedError

    def quarantine(self, key: str) -> None:
        """Move a corrupt blob aside: the key reads as missing afterwards
        (so read-repair can rewrite it) but the bad bytes are kept for
        forensics instead of destroyed."""
        raise NotImplementedError


class MemoryStorage(Storage):
    scheme = "mem"

    def __init__(self) -> None:
        self._blobs: dict[str, bytes] = {}
        self._quarantined: dict[str, bytes] = {}
        self._lock = make_lock("storage")

    def put(self, data: bytes) -> str:
        key = checksum(data)
        with self._lock:
            self._blobs[key] = bytes(data)
        return f"mem://{key}"

    def get(self, url: str) -> bytes:
        key = url.split("://", 1)[1]
        with self._lock:
            if key not in self._blobs:
                raise NotFoundError(f"blob {url} not found")
            data = self._blobs[key]
        if checksum(data) != key:
            raise ConflictError(f"blob {url} failed its content-address check")
        return data

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._blobs)

    def quarantine(self, key: str) -> None:
        with self._lock:
            data = self._blobs.pop(key, None)
            if data is not None:
                self._quarantined[key] = data


class LocalStorage(Storage):
    """Directory-backed content-addressed store (stands in for S3)."""

    scheme = "local"

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def put(self, data: bytes) -> str:
        key = checksum(data)
        path = os.path.join(self.root, key)
        if not os.path.exists(path):  # immutable: same content = same blob
            _write_atomic(path, data)
        return f"local://{key}"

    def get(self, url: str) -> bytes:
        key = url.split("://", 1)[1]
        path = os.path.join(self.root, key)
        if not os.path.exists(path):
            raise NotFoundError(f"blob {url} not found")
        with open(path, "rb") as f:
            data = f.read()
        if checksum(data) != key:
            raise ConflictError(f"blob {url} failed its content-address check")
        return data

    def keys(self) -> list[str]:
        # Blob files are bare hex keys; tmp files and quarantined copies
        # carry a dotted suffix and never count as stored content.
        return sorted(n for n in os.listdir(self.root) if "." not in n)

    def quarantine(self, key: str) -> None:
        path = os.path.join(self.root, key)
        if os.path.exists(path):
            os.replace(path, path + f".quarantined-{secrets.token_hex(4)}")


# ---------------------------------------------------------------------------
# Client-side sync helper (what executors use)
# ---------------------------------------------------------------------------


class CFSClient:
    """Upload/download helper pairing the metadata plane with a Storage.

    ``retry=RetryPolicy(...)`` makes every blob put/get survive transient
    storage failure (a sharded store with all of one key's replicas
    momentarily unreachable, an injected ``blob.*`` fault) with the same
    capped decorrelated-jitter backoff the RPC transports use. Only
    transport-shaped errors are retried; a checksum mismatch is
    deterministic and surfaces immediately.
    """

    def __init__(
        self,
        client,
        storage: Storage,
        prvkey: str,
        retry: RetryPolicy | None = None,
    ) -> None:
        self.client = client
        self.storage = storage
        self.prvkey = prvkey
        self.retry = retry

    # -- blob-plane retry ---------------------------------------------------
    def _blob_retry(self, attempt: Callable[[], Any]) -> Any:
        """Drive one storage operation under the retry policy.

        Retries ``TransportError`` (a sharded store with zero reachable
        replicas) and ``ConnectionError``/``OSError`` (a raw backend or
        an injected fault); ``NotFoundError``/``ConflictError`` are
        answers, not failures, and propagate immediately.
        """
        if self.retry is None:
            return attempt()
        deadline = time.monotonic() + self.retry.deadline_s
        delays = self.retry.delays()
        budget = max(1, self.retry.budget)
        for i in range(budget):
            try:
                return attempt()
            except (TransportError, ConnectionError, TimeoutError):
                if i + 1 >= budget:
                    raise
                delay = delays.next_delay()
                if time.monotonic() + delay >= deadline:
                    raise
            time.sleep(delay)
        raise TransportError("blob retry budget exhausted")  # pragma: no cover

    # -- path safety --------------------------------------------------------
    @staticmethod
    def _safe_dest(localdir: str, rel_label: str, name: str) -> str:
        """Join server-supplied path pieces under ``localdir``, rejecting
        anything that could escape it (``..``, separators inside the
        name, absolute components). CFS labels/names are untrusted
        metadata: a file named ``../evil`` must never materialize outside
        the target directory."""
        parts = [c for c in rel_label.split("/") if c]
        parts.append(name)
        for c in parts:
            if (
                not c
                or c in (".", "..")
                or "/" in c
                or "\\" in c
                or os.sep in c
                or (os.altsep and os.altsep in c)
            ):
                raise ValidationError(
                    f"unsafe path component {c!r} in CFS entry"
                    f" (label {rel_label!r}, name {name!r})"
                )
        return os.path.join(localdir, *parts)

    # -- single files -------------------------------------------------------
    def upload_bytes(self, colony: str, label: str, name: str, data: bytes) -> dict:
        url = self._blob_retry(lambda: self.storage.put(data))
        return self.client.add_file(
            {
                "colonyname": colony,
                "label": label,
                "name": name,
                "size": len(data),
                "checksum": checksum(data),
                "storage": {"backend": self.storage.scheme, "url": url},
            },
            self.prvkey,
        )

    def download_bytes(self, colony: str, label: str, name: str) -> bytes:
        meta = self.client.get_file(colony, label, name, self.prvkey)
        data = self._fetch_blob(meta)
        return data

    def _fetch_blob(self, meta: dict) -> bytes:
        """Fetch + verify one CFS entry's bytes (retry-backed)."""
        storage_ref = meta.get("storage") or {}
        url = storage_ref.get("url")
        if not url:
            raise ValidationError(
                f"CFS entry {meta.get('label')!r}/{meta.get('name')!r}"
                " carries no storage url"
            )
        data = self._blob_retry(lambda: self.storage.get(url))
        if checksum(data) != meta["checksum"]:
            raise ConflictError(
                f"checksum mismatch for {meta.get('label')}/{meta.get('name')}"
            )
        return data

    # -- directory sync -------------------------------------------------------
    def sync_up(self, colony: str, label: str, localdir: str) -> list[dict]:
        """Upload every file under localdir to the label (new revisions)."""
        out = []
        for root, _dirs, files in os.walk(localdir):
            for fn in sorted(files):
                path = os.path.join(root, fn)
                rel = os.path.relpath(path, localdir)
                sub = os.path.dirname(rel)
                lbl = label if not sub else label.rstrip("/") + "/" + sub.replace(os.sep, "/")
                with open(path, "rb") as f:
                    out.append(self.upload_bytes(colony, lbl, os.path.basename(rel), f.read()))
        return out

    def _materialize_entry(self, meta: dict, base_label: str, localdir: str) -> str:
        """Fetch one entry and write it crash-safely under localdir."""
        rel_label = meta["label"][len(base_label):].lstrip("/")
        dest = self._safe_dest(localdir, rel_label, meta["name"])
        data = self._fetch_blob(meta)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        _write_atomic(dest, data)
        return dest

    def sync_down(self, colony: str, label: str, localdir: str) -> list[str]:
        """Materialize the latest revision of every file under label."""
        os.makedirs(localdir, exist_ok=True)
        base = self._norm(label)
        return [
            self._materialize_entry(meta, base, localdir)
            for meta in self.client.get_files(colony, label, self.prvkey)
        ]

    def materialize_snapshot(self, colony: str, snapshotid: str, localdir: str) -> list[str]:
        """Write a pinned snapshot's exact revisions into localdir."""
        snap = self.client.get_snapshot(colony, snapshotid, self.prvkey)
        os.makedirs(localdir, exist_ok=True)
        return [
            self._materialize_entry(meta, snap["label"], localdir)
            for meta in snap["files"]
        ]

    @staticmethod
    def _norm(label: str) -> str:
        if not label.startswith("/"):
            label = "/" + label
        return label.rstrip("/") or "/"
