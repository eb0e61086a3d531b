"""Port serving parity: the torch ``ServeEngine`` and batch handler against
the reference's, on the same weights, and the port's engine answering
ColonyOS requests behind the reference broker."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro.serve import batcher as ref_batcher
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_reference
from repro_torch.runtime.store import MemoryStore
from repro_torch.serve import batcher
from repro_torch.serve.engine import ServeEngine


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def engines():
    """(reference engine, port engine) on the same weights, per arch."""
    out = {}
    for arch in ("stablelm-3b", "granite-3-8b"):
        rcfg = _f32(ref_get_config(arch, "smoke"))
        rparams = R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32)
        params = params_from_reference(jax.tree.map(np.asarray, rparams), "cpu")
        out[arch] = (RefEngine(rcfg, rparams, max_len=48),
                     ServeEngine(_f32(get_config(arch, "smoke")), params, max_len=48, device="cpu"))
    return out


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-3-8b"])
def test_greedy_tokens_match_reference_engine(arch, engines):
    ref, port = engines[arch]
    prompts = np.random.default_rng(1).integers(0, port.cfg.vocab_size, (2, 8)).astype(np.int32)
    want = ref.generate(prompts, max_new_tokens=6)
    got = port.generate(prompts, max_new_tokens=6)
    assert got.shape == (2, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_sampling_is_seeded(engines):
    _, port = engines["stablelm-3b"]
    prompts = np.random.default_rng(2).integers(0, port.cfg.vocab_size, (3, 5)).astype(np.int32)
    a = port.generate(prompts, max_new_tokens=7, temperature=0.8, seed=11)
    b = port.generate(prompts, max_new_tokens=7, temperature=0.8, seed=11)
    assert a.shape == (3, 7) and ((a >= 0) & (a < port.cfg.vocab_size)).all()
    np.testing.assert_array_equal(a, b)


class _RecordingEngine:
    def __init__(self):
        self.calls = []

    def generate(self, prompts, max_new_tokens=16):
        self.calls.append((prompts.copy(), max_new_tokens))
        return np.arange(prompts.shape[0] * max_new_tokens).reshape(prompts.shape[0], -1)


REQUESTS = [
    {"request_id": "a", "prompt": [5, 6, 7], "max_new_tokens": 3},
    {"request_id": "b", "prompt": [9], "max_new_tokens": 5},
    {"request_id": "c", "prompt": [1, 2, 3, 4, 5, 6], "max_new_tokens": 2},
]


def test_batch_handler_pads_like_reference():
    ref_engine, port_engine = _RecordingEngine(), _RecordingEngine()
    ref_sink, port_sink = MemoryStore(), MemoryStore()
    assert ref_batcher.make_batch_handler(ref_engine, ref_sink, "dev")(None, packed_args=REQUESTS) == [3]
    assert batcher.make_batch_handler(port_engine, port_sink, "dev")(None, packed_args=REQUESTS) == [3]
    (rp, rn), (pp, pn) = ref_engine.calls[0], port_engine.calls[0]
    np.testing.assert_array_equal(pp, rp)
    assert pp.dtype == rp.dtype and pn == rn == 5
    assert port_sink.files == ref_sink.files
    assert batcher.make_batch_handler(port_engine, port_sink, "dev")(None) == [0]


def test_padded_batch_tokens_match_reference(engines):
    """Ragged prompts left-padded with token 0 and no mask give the same
    tokens through both handlers."""
    ref, port = engines["granite-3-8b"]
    ref_sink, port_sink = MemoryStore(), MemoryStore()
    ref_batcher.make_batch_handler(ref, ref_sink, "dev")(None, packed_args=REQUESTS)
    batcher.make_batch_handler(port, port_sink, "dev")(None, packed_args=REQUESTS)
    assert port_sink.files == ref_sink.files
    assert len(json.loads(port_sink.files[("dev", "/results", "b.json")])["tokens"]) == 5


def test_port_engine_behind_colonyos_generator(colony):
    """The paper's heterogeneous-executor case: the reference broker fires
    a generator batch at an executor whose handler runs the torch engine."""
    from repro.core.executor import ExecutorBase
    from repro.core.fs import CFSClient, MemoryStorage
    from repro.runtime.jax_executor import ServeExecutor

    client, srv = colony["client"], colony["server"]
    srv.start_background(failsafe_interval=0.05)
    storage = MemoryStorage()
    # Never started: only its engine and weights are used.
    jax_ex = ServeExecutor(client, "dev", "serve-jax", "tpu-serve", storage,
                           colony_prvkey=colony["colony_prv"], arch="stablelm-3b", max_len=64)
    cfg = _f32(get_config("stablelm-3b", "smoke"))
    params = params_from_reference(jax.tree.map(np.asarray, jax_ex.engine.params), "cpu")
    port_engine = ServeEngine(cfg, params, max_len=64, device="cpu")

    ex = ExecutorBase(client, "dev", "serve-torch", "torch-serve", colony_prvkey=colony["colony_prv"])
    ex.register_function(
        "generate_batch",
        batcher.make_batch_handler(port_engine, CFSClient(client, storage, ex.prvkey), "dev"),
    )
    ex.start(poll_timeout=0.2)
    try:
        wf = {
            "colonyname": "dev",
            "functionspecs": [
                {"nodename": "batch", "funcname": "generate_batch",
                 "conditions": {"executortype": "torch-serve", "dependencies": []}}
            ],
        }
        g = client.add_generator(
            {"colonyname": "dev", "name": "torch-gen", "queuesize": 3, "timeout": 1.0,
             "workflow": wf},
            colony["colony_prv"],
        )
        cfs = CFSClient(client, storage, colony["colony_prv"])
        infc = ref_batcher.InferenceClient(client, cfs, "dev", g["generatorid"], colony["colony_prv"])
        prompts = [[1, 2, 3, 4 + i] for i in range(3)]
        rids = [infc.submit(p, max_new_tokens=4) for p in prompts]
        outs = [infc.wait(r, timeout=30) for r in rids]
    finally:
        ex.stop()
    assert port_engine.stats == {"requests": 3, "tokens": 12, "batches": 1}  # ONE batched call
    want = jax_ex.engine.generate(np.asarray(prompts, np.int32), max_new_tokens=4)
    assert outs == want.tolist()
