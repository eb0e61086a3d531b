"""A CPU ``TrainerExecutor`` behind the port's replicated broker
(``HAColonyCluster``), crashed at step 2 and failed over (the leader
replica killed after the crash), with its checkpoints on a
``ShardedStorage`` with a dead shard, ends with parameters bit-equal to
the same run behind ``standalone_server``."""

import time

import torch

from repro_torch.broker import standalone_server
from repro_torch.core.blobstore import ShardedStorage
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.fs import CFSClient, MemoryStorage
from repro_torch.runtime import faults
from repro_torch.runtime import torch_executor as tx
from repro_torch.runtime import train_loop
from repro_torch.tree import leaves_with_names
from test_torch_ha import _Rig

TRAIN_KW = {"arch": "stablelm-3b", "steps": 4, "batch": 2, "seq_len": 16,
            "checkpoint_every": 2, "run": "ha"}
# The train lease. The crashed attempt (steps 0-1 and one checkpoint)
# took 4.6 s alone on an 8-core CPU, the resumed one (a restore, steps 2-3
# and one checkpoint, each checkpoint about 80 signed CFS requests) 10.5 s.
# An attempt that outlives the lease under load is re-queued, closes with a
# conflict, and the next resumes from the last checkpoint: the parameters
# are the same, only the run takes longer (maxretries 3).
TRAIN_LEASE_S = 12


def _train_behind(client: Colonies, colony_prv: str, on_crash=None) -> dict:
    """A smoke train spec on a CPU TrainerExecutor that crashes at step 2,
    with its checkpoints on 3 shards (R = 2) of which shard 1 is dead
    throughout; returns the run's final parameters and the process."""
    store = ShardedStorage([MemoryStorage() for _ in range(3)], replicas=2)
    dead = faults.FaultPlan([faults.FaultRule(site, "crash", match={"shard": 1}, times=None)
                             for site in ("blob.put", "blob.get")])
    with faults.active(dead):
        trainer = tx.TrainerExecutor(client, "dev", "h100-a", "h100-pod", store, die_at_step=2,
                                     colony_prvkey=colony_prv, device="cpu")
        trainer.start(poll_timeout=0.2)
        try:
            p = client.submit({"conditions": {"colonyname": "dev", "executortype": "h100-pod"},
                               "funcname": "train", "kwargs": TRAIN_KW,
                               "maxexectime": TRAIN_LEASE_S, "maxretries": 3}, colony_prv)
            deadline = time.time() + 60
            while trainer.failed == 0 and time.time() < deadline:
                time.sleep(0.05)
            assert trainer.failed == 1, "the trainer did not crash"
            if on_crash is not None:
                on_crash()
            done = client.wait(p["processid"], colony_prv, timeout=120)
        finally:
            trainer.stop()
        cfs = CFSClient(client, store, colony_prv)
        params = train_loop.serve_engine(cfs, "dev", arch="stablelm-3b", run="ha",
                                         device="cpu").params
    assert dead.fired() > 0
    assert store.stats()["put_failures"] > 0
    return {"params": params, "process": done, "store": store}


def test_training_through_a_failover_equals_standalone():
    rig = _Rig("inproc", seed=51, failsafe_interval=0.1)
    killed = []

    def kill_leader():
        lid = rig.cluster.raft.leader_id()
        rig.cluster.kill_server(int(lid[1:]))
        killed.append(lid)

    try:
        ha = _train_behind(rig.client, rig.colony_prv, on_crash=kill_leader)
        assert rig.cluster.raft.leader_id() not in (None, killed[0])
    finally:
        rig.stop()
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    srv = standalone_server(Crypto.id(server_prv))
    srv.start_background(failsafe_interval=0.1)
    try:
        client = Colonies(InProcTransport([srv]))
        client.add_colony("dev", Crypto.id(colony_prv), server_prv)
        alone = _train_behind(client, colony_prv)
    finally:
        srv.stop()
    for run in (ha, alone):
        p = run["process"]
        assert p["state"] == "successful" and p["retries"] >= 1, p
        assert p["out"][0]["final_step"] == 3
    ours, theirs = leaves_with_names(ha["params"]), leaves_with_names(alone["params"])
    assert [n for n, _ in ours] == [n for n, _ in theirs] and len(ours) > 10
    for (name, a), (_, b) in zip(ours, theirs):
        assert torch.equal(a, b), name
    # the dead shard left keys on one replica; a scrub restores both
    report = ha["store"].scrub()
    assert report["lost"] == 0 and report["repaired"] > 0
