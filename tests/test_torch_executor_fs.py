"""The torch executors' CFS sync directives (paper §3.4.5, Listing 2)
against the reference's broker, on the reference's ``ShardedStorage``: the
port's copies of ``tests/test_blobstore.py::TestExecutorSyncDirectives``.
A snapshot mounts its pinned revisions (a later revision does not leak
in), ``fs.dirs`` sync down and back up, sync rides out one dead storage
shard, and an unsafe ``dir`` fails the process without escaping the
workdir."""

import os

import pytest

from repro.core.blobstore import ShardedStorage
from repro.core.fs import MemoryStorage as RefMemoryStorage
from repro.runtime import faults
from repro.runtime.faults import FaultPlan, FaultRule
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.fs import CFSClient, checksum
from repro_torch.core.retry import RetryPolicy
from repro_torch.runtime.torch_executor import TorchExecutorBase

FAST_RETRY = RetryPolicy(base_s=0.001, cap_s=0.01, deadline_s=5.0, budget=8, seed=7)


def dead_shard(idx):
    """A plan that makes shard ``idx`` unreachable for every blob op."""
    return FaultPlan([
        FaultRule("blob.put", "crash", match={"shard": idx}, times=None),
        FaultRule("blob.get", "crash", match={"shard": idx}, times=None),
    ])


@pytest.fixture()
def rig(colony, tmp_path):
    """The port's client and CFS client on the colony's broker, over a
    reference ShardedStorage of 3 shards, 2 replicas."""
    client = Colonies(InProcTransport([colony["server"]], retry=FAST_RETRY))
    store = ShardedStorage([RefMemoryStorage() for _ in range(3)], replicas=2)
    cfs = CFSClient(client, store, colony["colony_prv"], retry=FAST_RETRY)
    return client, cfs, store


def _executor(colony, client, store, tmp_path, handler):
    ex = TorchExecutorBase(client, "dev", "fs-worker", "fsw", storage=store,
                           colony_prvkey=colony["colony_prv"], blob_retry=FAST_RETRY,
                           workdir_root=str(tmp_path / "work"), device="cpu")
    ex.register_function("consume", handler)
    return ex


def _spec(fs):
    return {"conditions": {"colonyname": "dev", "executortype": "fsw"}, "funcname": "consume",
            "maxexectime": 30, "fs": fs}


def test_snapshot_and_dirs_sync_roundtrip(colony, rig, tmp_path):
    client, cfs, store = rig
    cfs.upload_bytes("dev", "/in", "data.txt", b"pinned input")
    snap = client.create_snapshot("dev", "/in", "s1", colony["colony_prv"])
    cfs.upload_bytes("dev", "/in", "data.txt", b"LATER revision")  # must not leak in

    def consume(ctx):
        with open(os.path.join(ctx.workdir, "in", "data.txt"), "rb") as f:
            data = f.read()
        out = os.path.join(ctx.workdir, "out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "result.txt"), "wb") as f:
            f.write(data.upper())
        return [len(data)]

    ex = _executor(colony, client, store, tmp_path, consume)
    fs = {"mount": "/cfs",
          "snapshots": [{"snapshotid": snap["snapshotid"], "label": "/in", "dir": "/cfs/in"}],
          "dirs": [{"label": "/out", "dir": "/cfs/out", "upload": True}]}
    p = client.submit(_spec(fs), colony["colony_prv"])
    assert ex.step(timeout=2.0)
    done = client.get_process(p["processid"], colony["colony_prv"])
    assert done["state"] == "successful", done.get("errors")
    assert done["out"] == [len(b"pinned input")]
    # the upload directive published the handler's output as CFS files
    assert cfs.download_bytes("dev", "/out", "result.txt") == b"PINNED INPUT"


def test_sync_survives_one_dead_shard(colony, rig, tmp_path):
    client, cfs, store = rig
    cfs.upload_bytes("dev", "/in2", "a.bin", b"alpha")
    cfs.upload_bytes("dev", "/in2", "b.bin", b"beta")
    seen = {}

    def consume(ctx):
        d = os.path.join(ctx.workdir, "in2")
        for fn in sorted(os.listdir(d)):
            with open(os.path.join(d, fn), "rb") as f:
                seen[fn] = f.read()
        return [sorted(seen)]

    ex = _executor(colony, client, store, tmp_path, consume)
    fs = {"mount": "/cfs", "dirs": [{"label": "/in2", "dir": "/cfs/in2", "upload": False}]}
    p = client.submit(_spec(fs), colony["colony_prv"])
    first = store.replicas_for(checksum(b"alpha"))[0]  # the replica a read asks first
    with faults.active(dead_shard(first)) as plan:
        assert ex.step(timeout=2.0)
    done = client.get_process(p["processid"], colony["colony_prv"])
    assert done["state"] == "successful", done.get("errors")
    assert seen == {"a.bin": b"alpha", "b.bin": b"beta"}
    assert plan.fired() >= 1  # the dead shard really was asked and failed


def test_malicious_directive_dir_fails_the_process(colony, rig, tmp_path):
    client, cfs, store = rig
    cfs.upload_bytes("dev", "/in3", "x.bin", b"x")
    ex = _executor(colony, client, store, tmp_path, lambda ctx: [])
    fs = {"mount": "/cfs", "dirs": [{"label": "/in3", "dir": "/cfs/../../etc", "upload": False}]}
    p = client.submit(_spec(fs), colony["colony_prv"])
    assert ex.step(timeout=2.0)
    done = client.get_process(p["processid"], colony["colony_prv"])
    assert done["state"] == "failed"
    assert any("ValidationError: unsafe fs directive" in e for e in done["errors"])
    # nothing escaped the sandbox root
    assert not (tmp_path.parent / "etc").exists()
