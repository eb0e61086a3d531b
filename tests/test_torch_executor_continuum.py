"""The paper's compute continuum on the torch executors: the port's copy of
``tests/test_integration_continuum.py::test_full_pipeline_with_executor_crash``
against the reference's broker (signatures verified, failsafe running):

  prepare_data (edge executor) -> train (h100-pod, chaos-crashed at step 3,
  the failsafe re-assigns, training resumes from the CFS checkpoint) ->
  evaluate -> results visible to the user.

The executors run on the CPU here (``device="cpu"``); a ``cuda``-marked
test runs one ``train`` spec on the card and counts flash attention's
launches."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.fs import MemoryStorage
from repro_torch.core.spec import FunctionSpec, WorkflowSpec
from repro_torch.runtime import torch_executor as tx

TRAIN_KW = {"arch": "stablelm-3b", "steps": 4, "batch": 2, "seq_len": 16,
            "checkpoint_every": 1, "run": "itest"}
# The train lease (maxexectime). An attempt that crashes at step 3 (steps
# 0-2, three checkpoints of 40 leaves through signed CFS requests) took
# 11.1 s alone on an 8-core CPU, the resumed attempt 5.2 s; the lease is
# 3x the longer, rounded up, so a healthy attempt keeps it under load and
# a crash is detected in at most 35 s (the reference waits out 60 s).
TRAIN_LEASE_S = 35


@pytest.fixture()
def port_client(colony):
    return Colonies(InProcTransport([colony["server"]]))


def test_full_pipeline_with_executor_crash(colony, port_client):
    client, srv = port_client, colony["server"]
    srv.start_background(failsafe_interval=0.1)
    storage = MemoryStorage()
    kw = dict(colony_prvkey=colony["colony_prv"], device="cpu")
    data_ex = tx.DataExecutor(client, "dev", "edge-1", "edge-data", storage, **kw)
    # BOTH trainers die at step 3 on their first assignment (the process is
    # never closed). The first crashes after steps 0-2; if the other takes
    # the re-queued process it crashes too, on resuming at step 3, before
    # running it; die_at_step clears after a crash, so a third attempt
    # completes. maxretries=5 > the worst case of 2.
    trainer_a = tx.TrainerExecutor(client, "dev", "h100-a", "h100-pod", storage, die_at_step=3,
                                   **kw)
    trainer_b = tx.TrainerExecutor(client, "dev", "h100-b", "h100-pod", storage, die_at_step=3,
                                   **kw)
    for ex in (data_ex, trainer_a, trainer_b):
        ex.start(poll_timeout=0.2)

    wf = WorkflowSpec.from_dict({
        "colonyname": "dev",
        "functionspecs": [
            {"nodename": "prep", "funcname": "prepare_data",
             "kwargs": {"shards": 2, "tokens_per_shard": 256},
             "conditions": {"executortype": "edge-data", "dependencies": []},
             "maxexectime": 30},
            {"nodename": "train", "funcname": "train", "kwargs": TRAIN_KW,
             "conditions": {"executortype": "h100-pod", "dependencies": ["prep"]},
             "maxexectime": TRAIN_LEASE_S, "maxretries": 5},
            {"nodename": "eval", "funcname": "evaluate",
             "kwargs": {"arch": "stablelm-3b", "batch": 2, "seq_len": 16, "run": "itest"},
             "conditions": {"executortype": "h100-pod", "dependencies": ["train"]},
             "maxexectime": 30},
        ],
    })
    r = client.submit_workflow(wf, colony["colony_prv"])
    procs = {p["spec"]["nodename"]: p for p in r["processes"]}
    done = client.wait(procs["eval"]["processid"], colony["colony_prv"], timeout=300)
    for ex in (data_ex, trainer_a, trainer_b):
        ex.stop()

    assert done["state"] == "successful", done["errors"]
    assert done["out"][0]["step"] == 3 and np.isfinite(done["out"][0]["eval_ce"])
    prep = client.get_process(procs["prep"]["processid"], colony["colony_prv"])
    assert prep["out"][0]["files"] == 2 and data_ex.processed == 1
    train_p = client.get_process(procs["train"]["processid"], colony["colony_prv"])
    assert train_p["state"] == "successful"
    assert train_p["retries"] >= 1, "chaos crash should have consumed a retry"
    assert train_p["out"][0]["final_step"] == 3
    # one trainer really did take (and lose) the process first; the other
    # may have crashed on its first attempt too, and no healthy attempt
    # lost its lease
    assert trainer_a.failed + trainer_b.failed in (1, 2)
    assert trainer_a.die_at_step is None or trainer_b.die_at_step is None


@pytest.mark.cuda
def test_train_spec_on_the_card_launches_flash_attention(colony, port_client):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa

    ex = tx.TrainerExecutor(port_client, "dev", "h100-1", "h100-pod", MemoryStorage(),
                            colony_prvkey=colony["colony_prv"], device="cuda")
    spec = FunctionSpec.from_dict({
        "conditions": {"colonyname": "dev", "executortype": "h100-pod"}, "funcname": "train",
        "kwargs": dict(TRAIN_KW, steps=2, checkpoint_every=2, run="card"), "maxexectime": 120})
    p = port_client.submit(spec, colony["colony_prv"])
    fa.launches = 0
    assert ex.step(timeout=5.0)
    launches = fa.launches
    done = port_client.get_process(p["processid"], colony["colony_prv"])
    assert done["state"] == "successful", done["errors"]
    assert done["out"][0]["final_step"] == 1
    # each layer's forward and its remat recomputation, every step
    assert launches == 2 * get_config("stablelm-3b", "smoke").num_layers * 2
