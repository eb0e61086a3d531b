"""The continuum's hand-offs through the reference's broker (signatures
verified): the port's copy of
``tests/test_integration_continuum.py::test_train_then_serve_handoff``
(train on one executor, sync the model through CFS, serve it on another,
behind a generator), with greedy tokens equal to the reference
``ServeExecutor``'s on the same checkpoint; and one DAG across both
frameworks: ``prepare_data`` on the reference's ``DataExecutor``, ``train``
on the port's ``TrainerExecutor``, ``evaluate`` on the reference's
``TrainerExecutor``."""

import numpy as np
import pytest

from repro.core.fs import CFSClient as RefCFSClient
from repro.core.fs import MemoryStorage as RefMemoryStorage
from repro.runtime.jax_executor import DataExecutor as RefDataExecutor
from repro.runtime.jax_executor import ServeExecutor as RefServeExecutor
from repro.runtime.jax_executor import TrainerExecutor as RefTrainerExecutor
from repro_torch import trace
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.fs import CFSClient
from repro_torch.core.spec import FunctionSpec, WorkflowSpec
from repro_torch.runtime import torch_executor as tx
from repro_torch.runtime import train_loop as tl
from repro_torch.serve.batcher import InferenceClient, pad_prompts

TRAIN_KW = {"arch": "stablelm-3b", "steps": 4, "batch": 2, "seq_len": 16, "checkpoint_every": 2}
# The train lease, as in test_torch_executor_continuum.py: 3x the longest
# attempt measured alone (11.1 s), rounded up.
TRAIN_LEASE_S = 35
PROMPTS = [[5, 9, 2], [7, 1, 4, 4, 8, 3], [11, 12]]


@pytest.fixture()
def port_client(colony):
    return Colonies(InProcTransport([colony["server"]]))


def test_train_then_serve_handoff(colony, port_client):
    """§Discussion: 'train a ML model on an HPC system, then use CFS to
    synchronize the trained model to a cloud environment'."""
    client, srv = port_client, colony["server"]
    srv.start_background(failsafe_interval=0.1)
    storage = RefMemoryStorage()  # one blob store, read by both frameworks' CFS clients
    trainer = tx.TrainerExecutor(client, "dev", "hpc-1", "h100-pod", storage,
                                 colony_prvkey=colony["colony_prv"], device="cpu")
    trainer.start(poll_timeout=0.2)
    p = client.submit(FunctionSpec.from_dict({
        "conditions": {"colonyname": "dev", "executortype": "h100-pod"},
        "funcname": "train", "kwargs": dict(TRAIN_KW, run="handoff"),
        "maxexectime": TRAIN_LEASE_S,
    }), colony["colony_prv"])
    done = client.wait(p["processid"], colony["colony_prv"], timeout=120)
    trainer.stop()
    assert done["state"] == "successful", done["errors"]
    assert done["out"][0]["final_step"] == 3

    # the "cloud" executor boots from the CFS checkpoint the trainer wrote
    server = tx.ServeExecutor(client, "dev", "cloud-1", "h100-serve", storage,
                              colony_prvkey=colony["colony_prv"], arch="stablelm-3b",
                              max_len=64, run="handoff", device="cpu")
    before = trace.snapshot()["counters"]
    server.start(poll_timeout=0.2)
    wf = {"colonyname": "dev",
          "functionspecs": [{"nodename": "batch", "funcname": "generate_batch",
                             "conditions": {"executortype": "h100-serve", "dependencies": []}}]}
    g = client.add_generator({"colonyname": "dev", "name": "handoff-gen",
                              "queuesize": len(PROMPTS), "timeout": 30.0, "workflow": wf},
                             colony["colony_prv"])
    cfs = CFSClient(client, storage, colony["colony_prv"])
    infc = InferenceClient(client, cfs, "dev", g["generatorid"], colony["colony_prv"])
    rids = [infc.submit(pr, max_new_tokens=5) for pr in PROMPTS]
    served = [infc.wait(r, timeout=60) for r in rids]
    server.stop()
    assert trace.counters_since(before)["serve.batches"] == 1
    requests = [{"prompt": pr} for pr in PROMPTS]
    assert served == server.engine.generate(pad_prompts(requests), max_new_tokens=5).tolist()
    # the reference's ServeExecutor restores the same checkpoint and serves
    # the same greedy tokens
    ref = RefServeExecutor(colony["client"], "dev", "cloud-ref", "tpu-serve", storage,
                           colony_prvkey=colony["colony_prv"], arch="stablelm-3b", max_len=64,
                           run="handoff")
    assert served == ref.engine.generate(pad_prompts(requests), max_new_tokens=5).tolist()


def test_one_dag_across_two_frameworks(colony, port_client):
    """prepare_data (JAX edge executor) -> train (torch) -> evaluate (JAX)."""
    srv = colony["server"]
    srv.start_background(failsafe_interval=0.1)
    storage = RefMemoryStorage()
    ref_kw = dict(colony_prvkey=colony["colony_prv"])
    data_ex = RefDataExecutor(colony["client"], "dev", "edge-ref", "edge-data", storage, **ref_kw)
    trainer = tx.TrainerExecutor(port_client, "dev", "h100-1", "h100-pod", storage,
                                 colony_prvkey=colony["colony_prv"], device="cpu")
    evaluator = RefTrainerExecutor(colony["client"], "dev", "tpu-1", "tpu-pod", storage, **ref_kw)
    for ex in (data_ex, trainer, evaluator):
        ex.start(poll_timeout=0.2)
    eval_kw = {"arch": "stablelm-3b", "batch": 2, "seq_len": 16, "run": "mixed"}
    wf = WorkflowSpec.from_dict({
        "colonyname": "dev",
        "functionspecs": [
            {"nodename": "prep", "funcname": "prepare_data",
             "kwargs": {"shards": 2, "tokens_per_shard": 256},
             "conditions": {"executortype": "edge-data", "dependencies": []},
             "maxexectime": 30},
            {"nodename": "train", "funcname": "train", "kwargs": dict(TRAIN_KW, run="mixed"),
             "conditions": {"executortype": "h100-pod", "dependencies": ["prep"]},
             "maxexectime": TRAIN_LEASE_S},
            {"nodename": "eval", "funcname": "evaluate", "kwargs": eval_kw,
             "conditions": {"executortype": "tpu-pod", "dependencies": ["train"]},
             "maxexectime": 60},
        ],
    })
    r = port_client.submit_workflow(wf, colony["colony_prv"])
    procs = {p["spec"]["nodename"]: p for p in r["processes"]}
    done = port_client.wait(procs["eval"]["processid"], colony["colony_prv"], timeout=300)
    for ex in (data_ex, trainer, evaluator):
        ex.stop()
    assert done["state"] == "successful", done["errors"]
    assert (data_ex.processed, trainer.processed, evaluator.processed) == (1, 1, 1)
    got = done["out"][0]
    assert got["step"] == 3 and np.isfinite(got["eval_ce"])
    # the port's own evaluation of the checkpoint the torch trainer wrote
    cfs = RefCFSClient(colony["client"], storage, colony["colony_prv"])
    own = tl.evaluate(cfs, "dev", device="cpu", **eval_kw)[0]
    assert own["step"] == 3
    assert got["eval_ce"] == pytest.approx(own["eval_ce"], abs=1e-5)
