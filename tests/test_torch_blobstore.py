"""The port's sharded blob plane (``repro_torch.core.blobstore``) against
the reference's ``repro.core.blobstore``: the same replica placement, and
the same bytes and per-shard counters after one scripted sequence of puts,
gets, corruption, missing copies, a dead shard (by each package's own
``FaultPlan``), read-repair, quarantine and ``scrub``. Then the port's
``CFSClient`` syncs through a dead shard behind the port's broker."""

import pytest

from repro.core import blobstore as ref_blobstore
from repro.core import fs as ref_fs
from repro.runtime import faults as ref_faults
from repro_torch.broker import standalone_server
from repro_torch.core import blobstore, fs
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.errors import TransportError
from repro_torch.core.fs import CFSClient, MemoryStorage, checksum
from repro_torch.core.retry import RetryPolicy
from repro_torch.runtime import faults

FAST_RETRY = RetryPolicy(base_s=0.001, cap_s=0.01, deadline_s=5.0, budget=16, seed=11)
PORT = (blobstore, fs, faults)
REFERENCE = (ref_blobstore, ref_fs, ref_faults)


def _dead(fmod, shard: int, **kw):
    return fmod.FaultPlan([fmod.FaultRule("blob.put", "crash", match={"shard": shard}, **kw),
                           fmod.FaultRule("blob.get", "crash", match={"shard": shard}, **kw)])


@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("n", [3, 4, 5])
def test_placement_equals_the_reference(n, replicas):
    ours = blobstore.ShardedStorage([MemoryStorage() for _ in range(n)], replicas=replicas)
    theirs = ref_blobstore.ShardedStorage([ref_fs.MemoryStorage() for _ in range(n)],
                                          replicas=replicas)
    keys = [checksum(f"key-{i}".encode()) for i in range(2000)]
    got = [ours.replicas_for(k) for k in keys]
    assert got == [theirs.replicas_for(k) for k in keys]
    assert all(len(set(r)) == min(replicas, n) for r in got)
    assert {r[0] for r in got} == set(range(n))  # every shard owns keys


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the error's class is the outcome
        return type(e).__name__


def _script(mods) -> dict:
    """One sequence through either package's store; returns every answer,
    the children's bytes, the quarantine and the counters."""
    bmod, fmod, fault = mods
    shards = [fmod.MemoryStorage() for _ in range(3)]
    store = bmod.ShardedStorage(shards, replicas=2)
    log = []
    blobs = [f"blob {i} ".encode() * (i + 1) for i in range(24)]
    urls = [store.put(b) for b in blobs[:12]]
    keys = [u.split("://", 1)[1] for u in urls]
    # rot and holes at rest: a corrupt first replica, a missing first
    # replica, both replicas corrupt, a missing second replica
    shards[store.replicas_for(keys[0])[0]]._blobs[keys[0]] = b"bitrot"
    del shards[store.replicas_for(keys[1])[0]]._blobs[keys[1]]
    for s in store.replicas_for(keys[2]):
        shards[s]._blobs[keys[2]] = b"rot"
    del shards[store.replicas_for(keys[3])[1]]._blobs[keys[3]]
    log += [_outcome(lambda u=u: store.get(u)) for u in urls]
    log.append(_outcome(lambda: store.get("shard://" + checksum(b"never stored"))))
    # a shard that serves gets but refuses puts: the repair fails, counted
    first = store.replicas_for(keys[4])[0]
    del shards[first]._blobs[keys[4]]
    with fault.active(fault.FaultPlan([fault.FaultRule("blob.put", "crash",
                                                       match={"shard": first}, times=None)])):
        log.append(_outcome(lambda: store.get(urls[4])))
    # shard 1 dies: puts keep one replica, gets rotate past it
    with fault.active(_dead(fault, 1, times=None)):
        urls += [store.put(b) for b in blobs[12:]]
        log += [_outcome(lambda u=u: store.get(u)) for u in urls]
        log.append([store.replica_count(u.split("://", 1)[1]) for u in urls])
    # two shards dead: a key on both has no reachable replica
    both = next(u for u in urls if sorted(store.replicas_for(u.split("://", 1)[1])) == [0, 1])
    plan = fault.FaultPlan(_dead(fault, 0, times=None).rules + _dead(fault, 1, times=None).rules)
    with fault.active(plan):
        log.append(_outcome(lambda: store.get(both)))
        log.append(_outcome(lambda: store.put(b"nowhere" * 3)))
    # the shards are back: scrub restores what can be restored, and
    # counts a key rotten on every replica as lost
    for s in store.replicas_for(keys[5]):
        shards[s]._blobs[keys[5]] = b"rot"
    log.append(store.scrub())
    log.append([store.replica_count(u.split("://", 1)[1]) for u in urls])
    log.append(store.scrub())
    return {"answers": log, "blobs": [dict(s._blobs) for s in shards],
            "quarantined": [dict(s._quarantined) for s in shards],
            "quarantine_log": list(store.quarantine_log), "stats": store.stats(),
            "keys": store.keys()}


def test_scripted_sequence_leaves_equal_bytes_and_counters():
    ours, theirs = _script(PORT), _script(REFERENCE)
    assert ours == theirs
    st = ours["stats"]
    # the script reached each path it set out to
    assert st["corrupt"] >= 2 and st["quarantined"] >= 2 and st["missing"] >= 2
    assert st["repairs"] > 0 and st["repair_failures"] >= 1 and st["put_failures"] > 0
    assert "NotFoundError" in ours["answers"] and "TransportError" in ours["answers"]
    first_scrub, second_scrub = ours["answers"][-3], ours["answers"][-1]
    assert first_scrub["repaired"] > 0 and first_scrub["lost"] == 1
    assert second_scrub["repaired"] == 0


def test_put_reaching_no_replica_raises_transport_error():
    store = blobstore.ShardedStorage([MemoryStorage() for _ in range(3)], replicas=2)
    data = b"no home"
    plan = faults.FaultPlan([faults.FaultRule("blob.put", "crash", match={"shard": s},
                                              times=None)
                             for s in store.replicas_for(checksum(data))])
    with faults.active(plan), pytest.raises(TransportError):
        store.put(data)
    assert plan.fired() == 2 and store.keys() == []
    assert store.stats()["put_failures"] == 2


def test_port_cfs_client_syncs_through_a_dead_shard(tmp_path):
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    srv = standalone_server(Crypto.id(server_prv))
    client = Colonies(InProcTransport([srv]))
    client.add_colony("dev", Crypto.id(colony_prv), server_prv)
    store = blobstore.ShardedStorage([MemoryStorage() for _ in range(3)], replicas=2)
    cfs = CFSClient(client, store, colony_prv, retry=FAST_RETRY)
    up = tmp_path / "up"
    up.mkdir()
    files = {f"f{i}.bin": f"payload {i} ".encode() * (i + 2) for i in range(6)}
    for name, data in files.items():
        (up / name).write_bytes(data)
    assert len(cfs.sync_up("dev", "/data", str(up))) == len(files)
    snap = client.create_snapshot("dev", "/data", "s0", colony_prv)
    with faults.active(_dead(faults, 0, times=None)) as plan:
        down = cfs.sync_down("dev", "/data", str(tmp_path / "down"))
        cfs.materialize_snapshot("dev", snap["snapshotid"], str(tmp_path / "snap"))
        cfs.upload_bytes("dev", "/data", "late.bin", b"written while shard 0 is dark")
    assert plan.fired() > 0 and len(down) == len(files)
    for d in ("down", "snap"):
        assert {p.name: p.read_bytes() for p in (tmp_path / d).iterdir()} == files
    assert cfs.download_bytes("dev", "/data", "late.bin") == b"written while shard 0 is dark"
    report = store.scrub()
    assert report["lost"] == 0 and all(store.replica_count(k) == 2 for k in store.keys())
    # the broker in this process counts this process's stores
    blob = client.stats("dev", colony_prv)["blob"]
    assert blob["stores"] >= 1 and blob["repairs"] >= report["repaired"]
    srv.stop()
