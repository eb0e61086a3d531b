"""The spans and counters on the port's serving path (``repro_torch.trace``):
the batch handler's counters against hand-worked lengths; a signed RPC over
a real ``ColoniesHttpServer`` on localhost, split into the client's
signature and the broker's recovery and handler (its ``Server-Timing``
header), with reply bodies byte for byte what the server returns without
the header, the dedup replay included; and ``generate``'s tokens and the
decode step's ``logits`` equal with and without a profiler recording, on
the CPU and (``cuda``) through the captured graph on a card."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.broker import ColoniesHttpServer, standalone_server
from repro_torch.configs import get_config
from repro_torch.core.client import Colonies, InProcTransport
from repro_torch.core.crypto import Crypto
from repro_torch.core.http_transport import HttpTransport, server_timing
from repro_torch.core.security import sign_envelope
from repro_torch.models import init_params, model_spec
from repro_torch.serve.batcher import make_batch_handler
from repro_torch.serve.engine import ServeEngine

KEYS = {"server": Crypto.prvkey(), "colony": Crypto.prvkey()}


@pytest.fixture(autouse=True)
def empty():
    trace.reset()
    yield
    trace.reset()


def _spans(name=None):
    return [s for s in trace.spans_between(0.0, float("inf"))
            if s.name != "python.gc" and (name is None or s.name == name)]


class _Engine:
    def __init__(self):
        self.calls = []

    def generate(self, prompts, max_new_tokens):
        self.calls.append((prompts.shape, max_new_tokens))
        return np.zeros((prompts.shape[0], max_new_tokens), np.int32)


class _CFS:
    def __init__(self):
        self.names = []

    def upload_bytes(self, colony, label, name, data):
        self.names.append(name)


def test_batch_handler_counts_by_hand():
    engine, cfs = _Engine(), _CFS()
    handler = make_batch_handler(engine, cfs, "dev")
    requests = [{"request_id": "r0", "prompt": [1, 2, 3], "max_new_tokens": 4},
                {"request_id": "r1", "prompt": [1, 2, 3, 4, 5], "max_new_tokens": 1},
                {"request_id": "r2", "prompt": [7, 8], "max_new_tokens": 2}]
    with trace.span("executor.execute", trace_id="pid-1") as execute:
        assert handler(None, packed_args=requests) == [3]
    assert engine.calls == [((3, 5), 4)]
    # prompts 3 + 5 + 2 in 3 rows of 5; asks 4 + 1 + 2 in 3 rows of 4
    want = {"prompt_tokens": 10, "prefill_tokens": 15, "asked_tokens": 7, "decode_slots": 12}
    assert trace.snapshot()["counters"] == dict(
        {f"serve.{k}": v for k, v in want.items()}, **{"serve.requests": 3, "serve.batches": 1})
    (pad,), (gen,) = _spans("serve.pad"), _spans("serve.generate")
    assert gen.attrs == want and gen.parent == pad.parent == execute.id
    assert gen.trace_id == pad.trace_id == "pid-1"
    publish = _spans("serve.publish")
    assert [s.trace_id for s in publish] == ["r0", "r1", "r2"]
    assert all(s.parent == execute.id for s in publish)
    assert cfs.names == ["r0.json", "r1.json", "r2.json"]
    # an empty batch counts nothing
    assert handler(None, packed_args=[]) == [0]
    assert trace.snapshot()["counters"]["serve.batches"] == 1


@pytest.fixture()
def broker():
    srv = standalone_server(Crypto.id(KEYS["server"]))
    http = ColoniesHttpServer(srv)
    http.start()
    try:
        client = Colonies(HttpTransport(http.host, http.port))
        client.add_colony("dev", Crypto.id(KEYS["colony"]), KEYS["server"])
        yield srv, http, client
    finally:
        http.stop()


def test_an_rpc_splits_into_signature_recovery_and_handler(broker):
    srv, _, client = broker
    trace.reset()
    client.stats("dev", KEYS["colony"])
    (rpc,) = _spans("rpc.colonystats")
    (sign,), (recover,), (handle,) = (_spans(n) for n in ("rpc.sign", "broker.recover",
                                                          "broker.handle"))
    assert sign.parent == recover.parent == handle.parent == rpc.id
    assert recover.seconds > 0 and handle.seconds > 0
    assert sign.seconds + recover.seconds + handle.seconds <= rpc.seconds
    assert rpc.start <= sign.start and recover.start + recover.seconds == \
        pytest.approx(handle.start)
    # a refused request's reply carries the broker's time too
    with pytest.raises(Exception):
        client.stats("dev", Crypto.prvkey())  # not a member: 403
    assert len(_spans("broker.recover")) == 2
    # the in-process transport reads no header: no broker spans
    trace.reset()
    Colonies(InProcTransport([srv])).stats("dev", KEYS["colony"])
    assert _spans("rpc.colonystats") and not _spans("broker.recover")


def _post(http, env) -> tuple[bytes, str | None]:
    req = urllib.request.Request(f"http://{http.host}:{http.port}/api",
                                 data=json.dumps(env).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.read(), resp.headers.get("Server-Timing")
    except urllib.error.HTTPError as e:
        return e.read(), e.headers.get("Server-Timing")


def test_reply_bodies_are_the_servers_byte_for_byte(broker):
    srv, http, _ = broker
    # read-only: the same envelope over HTTP (with the header) and in process
    env = sign_envelope("colonystats", {"colonyname": "dev"}, KEYS["colony"])
    body, header = _post(http, env)
    assert body == json.dumps(srv.handle(env)).encode()
    assert set(server_timing(header)) == {"recover", "handle"}
    # keyed: the first reply commits, the retries replay the recorded reply
    env = sign_envelope("addcolony", {"colony": {"colonyname": "second",
                                                 "colonyid": Crypto.id(Crypto.prvkey())}},
                        KEYS["server"], msgid="m-1")
    first, _ = _post(http, env)
    replayed, header = _post(http, env)
    assert json.loads(replayed) == dict(json.loads(first), replayed=True)
    assert replayed == json.dumps(srv.handle(env)).encode()
    assert set(server_timing(header)) == {"recover", "handle"}
    # an error reply
    env = sign_envelope("colonystats", {"colonyname": "dev"}, Crypto.prvkey())
    body, header = _post(http, env)
    assert body == json.dumps(srv.handle(env)).encode() and b"403" in body
    assert set(server_timing(header)) == {"recover", "handle"}


def _engine(arch="stablelm-3b"):
    cfg = get_config(arch, "smoke").copy(param_dtype="float32", compute_dtype="float32")
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    return cfg, params


def _generate_twice(engine, temperature):
    """(tokens, the step's logits, their address) without a profiler, then
    with one."""
    prompts = np.random.default_rng(3).integers(1, engine.cfg.vocab_size, (3, 6)).astype(np.int32)
    out = []
    for traced in (False, True):
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                tokens = engine.generate(prompts, max_new_tokens=5, temperature=temperature,
                                         seed=7)
        else:
            tokens = engine.generate(prompts, max_new_tokens=5, temperature=temperature, seed=7)
        (step,) = engine.steps.values()
        out.append((tokens, step.logits.clone(), step.logits.data_ptr()))
    return out


@pytest.mark.parametrize("arch", ["stablelm-3b", "rwkv6-7b"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_is_the_same_under_a_profiler(arch, temperature):
    cfg, params = _engine(arch)
    engine = ServeEngine(cfg, params, max_len=16, device="cpu")
    (plain, plain_logits, _), (traced, traced_logits, _) = _generate_twice(engine, temperature)
    np.testing.assert_array_equal(plain, traced)
    assert torch.equal(plain_logits, traced_logits)
    device = trace.snapshot()["device"]
    # every step of the traced call ran the body under a device span
    assert device["decode.step"]["count"] == 4
    assert device["decode.mixer"]["count"] == device["decode.mlp"]["count"] == 4 * cfg.num_layers
    assert 0 < device["decode.mixer"]["seconds"] + device["decode.mlp"]["seconds"] < \
        device["decode.step"]["seconds"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-3b", "rwkv6-7b"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_generate_is_the_same_under_a_profiler(arch, temperature):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params = _engine(arch)
    engine = ServeEngine(cfg, params, max_len=16, device="cuda")
    (plain, plain_logits, plain_at), (traced, traced_logits, traced_at) = \
        _generate_twice(engine, temperature)
    (step,) = engine.steps.values()
    assert step.graph is not None
    np.testing.assert_array_equal(plain, traced)
    assert torch.equal(plain_logits, traced_logits)
    assert plain_at == traced_at  # still the graph's output tensor
    device = trace.snapshot()["device"]
    # one probe step, its mixers and MLPs on the card's clock; the rest replayed
    assert device["decode.step"]["count"] == 1
    assert device["decode.mixer"]["count"] == device["decode.mlp"]["count"] == cfg.num_layers
    assert 0 < device["decode.mixer"]["seconds"] + device["decode.mlp"]["seconds"] < \
        device["decode.step"]["seconds"]


@pytest.mark.cuda
def test_cuda_one_probe_step_leaves_its_logits_in_the_graphs_output():
    """With one step to run, the probe is the whole decode: its logits are
    what ``logits`` holds afterwards, as a replay's would be."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params = _engine()
    engine = ServeEngine(cfg, params, max_len=16, device="cuda")
    prompts = np.random.default_rng(4).integers(1, cfg.vocab_size, (3, 6)).astype(np.int32)
    plain = engine.generate(prompts, max_new_tokens=2)
    (step,) = engine.steps.values()
    plain_logits, at = step.logits.clone(), step.logits.data_ptr()
    engine.generate(prompts[::-1].copy(), max_new_tokens=2)  # other logits in between
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = engine.generate(prompts, max_new_tokens=2)
    np.testing.assert_array_equal(plain, traced)
    assert step.logits.data_ptr() == at and torch.equal(step.logits, plain_logits)


def test_the_engine_counts_the_keys_it_drops():
    from repro_torch.serve.engine import MAX_DECODE_KEYS

    cfg, params = _engine()
    engine = ServeEngine(cfg, params, max_len=16, device="cpu")
    for b in range(1, MAX_DECODE_KEYS + 3):  # one key a batch size
        engine.generate(np.ones((b, 4), np.int32), max_new_tokens=2)
    counters = trace.snapshot()["counters"]
    assert counters["engine.key_evictions"] == 2 and "engine.captures" not in counters
    spans = trace.snapshot()["spans"]
    assert spans["engine.prefill"]["count"] == spans["engine.fetch"]["count"] == \
        MAX_DECODE_KEYS + 2


@pytest.mark.cuda
def test_cuda_the_engine_counts_its_captures():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params = _engine()
    engine = ServeEngine(cfg, params, max_len=16, device="cuda")
    for b in (2, 3, 2):
        engine.generate(np.ones((b, 4), np.int32), max_new_tokens=2)
    assert trace.snapshot()["counters"]["engine.captures"] == 2
    assert trace.snapshot()["spans"]["engine.capture"]["count"] == 2
