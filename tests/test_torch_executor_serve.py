"""Generator batching through the port's ``ServeExecutor`` and
``InferenceClient`` on the reference's broker: the port's copy of
``tests/test_checkpoint_serve.py::test_generator_dynamic_batching_end_to_end``
(3 requests, one batched call), with greedy tokens equal to the reference
``ServeExecutor``'s on the same weights. Executors built without a device
run on the card and raise without one; every thread that runs a handler
has warmed its OpenMP team's ``exp`` first (ROADMAP C11)."""

import threading

import jax
import numpy as np
import pytest
import torch

from repro.runtime.jax_executor import ServeExecutor as RefServeExecutor
from repro.core.fs import MemoryStorage as RefMemoryStorage
from repro_torch import device as port_device
from repro_torch import trace
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.fs import CFSClient, MemoryStorage
from repro_torch.interop import params_from_reference
from repro_torch.runtime import torch_executor as tx
from repro_torch.serve.batcher import InferenceClient


@pytest.fixture()
def port_client(colony):
    return Colonies(InProcTransport([colony["server"]]))


def test_generator_batches_requests_into_one_port_engine_call(colony, port_client):
    srv = colony["server"]
    srv.start_background(failsafe_interval=0.05)
    storage = MemoryStorage()
    ex = tx.ServeExecutor(port_client, "dev", "serve-1", "h100-serve", storage,
                          colony_prvkey=colony["colony_prv"], arch="stablelm-3b", max_len=64,
                          device="cpu")
    # the reference's executor builds its engine from jax.random.key(0); the
    # port's engine serves those weights, carried across through numpy
    ref = RefServeExecutor(colony["client"], "dev", "serve-ref", "tpu-serve", RefMemoryStorage(),
                           colony_prvkey=colony["colony_prv"], arch="stablelm-3b", max_len=64)
    ex.engine.params = params_from_reference(jax.tree.map(np.asarray, ref.engine.params))
    before = trace.snapshot()["counters"]
    ex.start(poll_timeout=0.2)
    wf = {"colonyname": "dev",
          "functionspecs": [{"nodename": "batch", "funcname": "generate_batch",
                             "conditions": {"executortype": "h100-serve", "dependencies": []}}]}
    # the batch fires on its third request; the timeout only bounds a batch
    # that never fills
    g = port_client.add_generator({"colonyname": "dev", "name": "serve-gen", "queuesize": 3,
                                   "timeout": 10.0, "workflow": wf}, colony["colony_prv"])
    cfs = CFSClient(port_client, storage, colony["colony_prv"])
    infc = InferenceClient(port_client, cfs, "dev", g["generatorid"], colony["colony_prv"])
    prompts = [[1, 2, 3, 4 + i] for i in range(2)] + [[7, 8, 9, 10, 11]]
    rids = [infc.submit(p, max_new_tokens=4) for p in prompts]
    outs = [infc.wait(r, timeout=60) for r in rids]
    ex.stop()
    assert all(len(o) == 4 for o in outs)
    served = trace.counters_since(before)
    assert served["serve.batches"] == 1  # 3 requests, ONE batched call
    assert served["serve.requests"] == 3
    assert served["serve.asked_tokens"] == served["serve.decode_slots"] == 12
    assert ex.processed == 1 and ex.failed == 0
    batch = [{"request_id": r, "prompt": p, "max_new_tokens": 4} for r, p in zip(rids, prompts)]
    want = ref.engine.generate(_pad(batch), max_new_tokens=4)
    assert outs == want.tolist()


def _pad(requests):
    """The reference batcher's padding: right-aligned, token 0 on the left."""
    longest = max(len(r["prompt"]) for r in requests)
    out = np.zeros((len(requests), longest), np.int32)
    for i, r in enumerate(requests):
        out[i, longest - len(r["prompt"]):] = r["prompt"]
    return out


@pytest.mark.parametrize("cls", ["TrainerExecutor", "ServeExecutor", "DataExecutor"])
def test_executors_default_to_the_card_and_raise_without_one(colony, port_client, cls):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tx, cls)(port_client, "dev", f"no-card-{cls}", "h100-pod", MemoryStorage(),
                         colony_prvkey=colony["colony_prv"])
    # it raised before registering: the colony never saw it
    assert port_client.list_executors("dev", colony["colony_prv"]) == []


def test_worker_thread_warms_exp_before_its_first_handler(colony, port_client, monkeypatch):
    events = []
    real = port_device.warm_cpu_exp

    def counting_warm():
        events.append(("warm", threading.get_ident()))
        real()

    monkeypatch.setattr(port_device, "warm_cpu_exp", counting_warm)
    ex = tx.TorchExecutorBase(port_client, "dev", "warm-1", "h100-pod", MemoryStorage(),
                              colony_prvkey=colony["colony_prv"], device="cpu")
    ex.register_function("probe", lambda ctx: events.append(("run", threading.get_ident())))
    spec = {"funcname": "probe", "conditions": {"colonyname": "dev", "executortype": "h100-pod"}}
    pids = [port_client.submit(spec, colony["colony_prv"])["processid"] for _ in range(2)]
    ex.start(poll_timeout=0.2)
    for pid in pids:
        assert port_client.wait(pid, colony["colony_prv"], timeout=30)["state"] == "successful"
    ex.stop()
    assert not ex._thread.is_alive()
    worker = ex._thread.ident
    assert worker != threading.get_ident()
    # once on the worker thread, before its first handler, and not again
    assert events == [("warm", worker), ("run", worker), ("run", worker)]
