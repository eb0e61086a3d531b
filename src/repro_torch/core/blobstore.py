"""Sharded, self-healing blob plane for CFS (STORAGE.md).

A copy of the reference's ``repro/core/blobstore.py``, stdlib only; its
locks (``blobshard:``, from ``analysis.locktrack.make_lock``) are never
held across a child-storage call.

The paper keeps CFS bytes in S3/IPFS-style distributed stores while the
Colonies database holds only metadata (§3.4.5). :class:`ShardedStorage`
is that distributed store: a content-addressed façade that
consistent-hashes every checksum key onto N child :class:`Storage`
shards with a configurable replication factor R.

Semantics (held to the reference's in tests/test_torch_blobstore.py):

* **put** writes to all R replicas of the key and succeeds as long as at
  least one write lands (tolerating up to R−1 shard failures per put);
  a put that reaches zero replicas raises ``TransportError`` — the
  transport-shaped failure ``CFSClient``'s retry policy knows to retry.
* **get** walks the key's replicas in ring order and rotates to the
  next replica when one is unreachable, missing, or checksum-corrupt.
* **read-repair** — a get that found a healthy copy rewrites every
  replica it *observed* broken on the way (missing or corrupt) from the
  healthy bytes, and **quarantines** corrupt copies (the child keeps the
  bad bytes aside for forensics; the slot is freed for the repair
  write). :meth:`scrub` extends this to every replica of every key —
  the self-healing pass a revived shard needs to regain full
  replication.
* **fault sites** — every child-shard operation passes through the
  compiled-in ``blob.put``/``blob.get`` fault points
  (``runtime/faults.py``) with ``shard``/``key`` context, so a
  seeded ``FaultPlan`` can kill exactly one
  shard mid-soak and the chaos gate can prove snapshots still
  materialize byte-identical.
* **counters** — per-shard op/byte/repair/quarantine counters, guarded
  by a ``blobshard`` lock (never held across a child-storage call; see
  CONCURRENCY.md), surfaced through the ``colonystats`` RPC via
  :func:`aggregate_stats`.

The ring is plain consistent hashing with virtual nodes: stable SHA-256
points, no RNG, no wall clock — fully deterministic, so tests and the
replication plane can rely on the shard map never moving under them.
"""

from __future__ import annotations

import bisect
import hashlib
import weakref

from ..analysis.locktrack import make_lock
from ..runtime import faults
from .errors import ConflictError, NotFoundError, TransportError
from .fs import Storage, checksum

# Virtual nodes per shard: enough that a 3-shard ring splits keys within
# a few percent of evenly (bench_storage.py prints the observed split).
VNODES = 64

# Child-shard failures that mean "this replica is unreachable right now"
# (rotate / tolerate), as opposed to "the bytes are provably absent or
# wrong" (NotFoundError / ConflictError, handled separately).
_TRANSIENT = (ConnectionError, TimeoutError, OSError, TransportError)

_COUNTERS = (
    "puts",
    "gets",
    "put_bytes",
    "get_bytes",
    "put_failures",
    "get_failures",
    "missing",
    "corrupt",
    "repairs",
    "repair_failures",
    "quarantined",
)

# Live stores of this process, for colonystats aggregation. A broker in a
# process of its own (over HTTP) holds none: it counts zero stores.
_registry_lock = make_lock("blobshard:registry")
_registry: list[weakref.ref] = []
_seq = 0


def _register(store: "ShardedStorage") -> int:
    global _seq
    with _registry_lock:
        _seq += 1
        _registry.append(weakref.ref(store))
        return _seq


def aggregate_stats() -> dict:
    """Fleet-wide blob-plane counters for ``colonystats``.

    Snapshots the registry under its lock, then queries each live store
    outside it (no blobshard lock ever nests another).
    """
    with _registry_lock:
        refs = list(_registry)
    stores = [s for s in (r() for r in refs) if s is not None]
    if len(stores) < len(refs):
        with _registry_lock:
            _registry[:] = [r for r in _registry if r() is not None]
    out: dict = {"stores": len(stores), "shards": 0}
    totals = {k: 0 for k in _COUNTERS}
    for store in stores:
        st = store.stats()
        out["shards"] += st["shards"]
        for shard_stats in st["per_shard"].values():
            for k in _COUNTERS:
                totals[k] += shard_stats[k]
    out.update(totals)
    return out


def _ring_point(data: str) -> int:
    return int.from_bytes(hashlib.sha256(data.encode()).digest()[:8], "big")


class ShardedStorage(Storage):
    """Content-addressed store over N child shards with R-way replication."""

    scheme = "shard"

    def __init__(
        self,
        shards: list[Storage],
        replicas: int = 2,
        vnodes: int = VNODES,
    ) -> None:
        if not shards:
            raise ValueError("ShardedStorage needs at least one child shard")
        if replicas < 1:
            raise ValueError("replication factor must be >= 1")
        self.shards = list(shards)
        self.replicas = min(replicas, len(self.shards))
        # Consistent-hash ring: sorted (point, shard_index) pairs, VNODES
        # stable SHA-256 points per shard. Key placement = first R
        # distinct shards clockwise from the key's own point.
        points: list[tuple[int, int]] = []
        for i in range(len(self.shards)):
            for v in range(vnodes):
                points.append((_ring_point(f"shard-{i}-vnode-{v}"), i))
        points.sort()
        self._ring_points = [p for p, _ in points]
        self._ring_shards = [s for _, s in points]
        # Counter lock: guards the per-shard counter dicts and the
        # quarantine log only — never held across a child put/get (the
        # children take their own `storage` locks; see CONCURRENCY.md).
        self._seq = _register(self)
        self._stats_lock = make_lock(f"blobshard:{self._seq}")
        self._per_shard = [dict.fromkeys(_COUNTERS, 0) for _ in self.shards]
        self.quarantine_log: list[tuple[int, str]] = []  # (shard, key)

    # ------------------------------------------------------------- placement
    def replicas_for(self, key: str) -> list[int]:
        """The key's R distinct shard indices, in ring (preference) order."""
        pos = bisect.bisect(self._ring_points, int(key[:16] or "0", 16))
        out: list[int] = []
        n = len(self._ring_points)
        for step in range(n):
            idx = self._ring_shards[(pos + step) % n]
            if idx not in out:
                out.append(idx)
                if len(out) == self.replicas:
                    break
        return out

    @staticmethod
    def _key_of(url: str) -> str:
        return url.split("://", 1)[1] if "://" in url else url

    def _bump(self, shard: int, counter: str, delta: int = 1) -> None:
        with self._stats_lock:
            self._per_shard[shard][counter] += delta

    # ---------------------------------------------------------- child shards
    # Both wrappers pass through the compiled-in fault points BEFORE
    # touching the child, so an injected crash models a shard that never
    # saw the request (the FaultInjected raise is a ConnectionError —
    # transient, tolerated by put and rotated past by get).
    def _shard_put(self, shard: int, key: str, data: bytes) -> None:
        faults.hit("blob.put", shard=shard, key=key)
        self.shards[shard].put(data)
        self._bump(shard, "puts")
        self._bump(shard, "put_bytes", len(data))

    def _shard_get(self, shard: int, key: str) -> bytes:
        faults.hit("blob.get", shard=shard, key=key)
        child = self.shards[shard]
        data = child.get(f"{child.scheme}://{key}")
        self._bump(shard, "gets")
        self._bump(shard, "get_bytes", len(data))
        return data

    def _quarantine(self, shard: int, key: str) -> None:
        """Move a checksum-corrupt copy aside on the child (best effort:
        a shard too broken to quarantine is already effectively empty)."""
        try:
            self.shards[shard].quarantine(key)
        except (NotFoundError, NotImplementedError, *_TRANSIENT):
            pass
        with self._stats_lock:
            self._per_shard[shard]["quarantined"] += 1
            self.quarantine_log.append((shard, key))

    def _repair(self, shard: int, key: str, data: bytes) -> bool:
        """Rewrite one broken replica from healthy bytes (read-repair)."""
        try:
            self._shard_put(shard, key, data)
        except _TRANSIENT:
            self._bump(shard, "repair_failures")
            return False
        self._bump(shard, "repairs")
        return True

    # ------------------------------------------------------------- Storage
    def put(self, data: bytes) -> str:
        key = checksum(data)
        ok = 0
        last: Exception | None = None
        for shard in self.replicas_for(key):
            try:
                self._shard_put(shard, key, data)
                ok += 1
            except _TRANSIENT as e:
                self._bump(shard, "put_failures")
                last = e
        if ok == 0:
            raise TransportError(
                f"blob put {key[:12]}…: all {self.replicas} replicas failed"
            ) from last
        return f"shard://{key}"

    def get(self, url: str) -> bytes:
        key = self._key_of(url)
        broken: list[int] = []  # replicas observed missing/corrupt
        transient = False
        data: bytes | None = None
        for shard in self.replicas_for(key):
            try:
                candidate = self._shard_get(shard, key)
            except NotFoundError:
                self._bump(shard, "missing")
                broken.append(shard)
                continue
            except ConflictError:
                # The child's own content-address check tripped.
                self._bump(shard, "corrupt")
                self._quarantine(shard, key)
                broken.append(shard)
                continue
            except _TRANSIENT:
                self._bump(shard, "get_failures")
                transient = True
                continue
            if checksum(candidate) != key:  # child without its own check
                self._bump(shard, "corrupt")
                self._quarantine(shard, key)
                broken.append(shard)
                continue
            data = candidate
            break
        if data is None:
            if transient:
                raise TransportError(
                    f"blob get {key[:12]}…: no healthy replica reachable"
                )
            raise NotFoundError(f"blob shard://{key} not found on any replica")
        for shard in broken:
            self._repair(shard, key, data)
        return data

    # ----------------------------------------------------------- self-healing
    def keys(self) -> list[str]:
        """Union of keys across reachable shards (sorted)."""
        seen: set[str] = set()
        for i, child in enumerate(self.shards):
            try:
                seen.update(child.keys())
            except _TRANSIENT:
                self._bump(i, "get_failures")
        return sorted(seen)

    def scrub(self) -> dict:
        """Probe EVERY replica of every key and repair the broken ones.

        ``get`` only repairs replicas it visited before finding a healthy
        copy; a scrub closes the gap — run it after reviving a shard to
        restore full replication. Unreachable shards are skipped (their
        copies are neither declared broken nor repaired). Returns
        ``{"keys", "repaired", "lost"}`` where ``lost`` counts keys with
        no healthy replica anywhere.
        """
        repaired = lost = 0
        all_keys = self.keys()
        for key in all_keys:
            healthy: bytes | None = None
            broken: list[int] = []
            for shard in self.replicas_for(key):
                try:
                    candidate = self._shard_get(shard, key)
                except NotFoundError:
                    broken.append(shard)
                    continue
                except ConflictError:
                    self._bump(shard, "corrupt")
                    self._quarantine(shard, key)
                    broken.append(shard)
                    continue
                except _TRANSIENT:
                    self._bump(shard, "get_failures")
                    continue
                if checksum(candidate) != key:
                    self._bump(shard, "corrupt")
                    self._quarantine(shard, key)
                    broken.append(shard)
                    continue
                if healthy is None:
                    healthy = candidate
            if healthy is None:
                lost += 1
                continue
            for shard in broken:
                if self._repair(shard, key, healthy):
                    repaired += 1
        return {"keys": len(all_keys), "repaired": repaired, "lost": lost}

    def replica_count(self, key: str) -> int:
        """How many of the key's replicas currently hold healthy bytes."""
        n = 0
        for shard in self.replicas_for(key):
            try:
                if checksum(self._shard_get(shard, key)) == key:
                    n += 1
            except (NotFoundError, ConflictError, *_TRANSIENT):
                pass
        return n

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._stats_lock:
            per_shard = {i: dict(c) for i, c in enumerate(self._per_shard)}
        totals = {k: sum(c[k] for c in per_shard.values()) for k in _COUNTERS}
        return {
            "shards": len(self.shards),
            "replicas": self.replicas,
            "per_shard": per_shard,
            **totals,
        }
