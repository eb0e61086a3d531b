"""The serving engine's decode step over static buffers (``DecodeStep``):
captured once per key in a CUDA graph on a card, run directly on the CPU.

On the CPU, for all ten archs at smoke size in float32 (every
cross-attention ``gate`` at 1.0, so the memory reaches the logits): the
port's engine gives the reference's jitted ``ServeEngine``'s greedy tokens
across two batch sizes on one engine; batch A then batch B on one engine
gives a fresh engine's tokens for B (no cache row survives a batch), with
one set of buffers for the key; the engine keeps its most recently used
keys and drops them all when its weights are assigned; the step body at
its tensor position gives eager ``decode_step``'s logits at int positions
bit for bit; and Gumbel-max draws follow softmax(logits / T). The
``cuda`` tests (``-m cuda`` on a card) hold the captured engine to an
eager ``decode_step`` loop on the card for all ten archs, with one capture
per key and no host sync in the replay loop, seeded sampling that
repeats, a capture on a worker thread while the main thread uses the
card, and the memory of a deleted engine and of a dropped key given back.
"""

import gc
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import decode_step, init_params, model_spec, prefill
from repro_torch.serve.engine import (MAX_DECODE_KEYS, DecodeStep, ServeEngine, make_serve_step,
                                      sample_token)
from repro_torch.tree import leaves, map_leaves

ARCHS = ["stablelm-3b", "granite-3-8b", "starcoder2-15b", "qwen2.5-14b", "mixtral-8x7b",
         "rwkv6-7b", "jamba-1.5-large-398b", "deepseek-v3-671b", "llama-3.2-vision-11b",
         "seamless-m4t-large-v2"]
BATCHES = [(4, 10), (3, 7)]  # (B, prompt length): two keys on one engine
NEW = 5
MAX_LEN = 16
SRC_FRAMES = 12  # seamless's memory length here
GATE = 1.0
LOGITS_BAR = 3e-2  # bf16's bar, should cuBLAS pick another algorithm under capture


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


def _with_gate(tree, value):
    if isinstance(tree, dict):
        return {k: jnp.full_like(v, value) if k == "gate" else _with_gate(v, value)
                for k, v in tree.items()}
    return tree


def _set_gates(params, value):
    for key, val in params.items():
        if key == "gate":
            val.fill_(value)
        elif isinstance(val, dict):
            _set_gates(val, value)


@pytest.fixture(scope="module")
def models():
    """Per arch, built once: (reference cfg, reference params, port cfg,
    port params on the CPU), smoke, f32, gates at ``GATE``."""
    out = {}
    for arch in ARCHS:
        rcfg = _f32(ref_get_config(arch, "smoke"))
        rparams = _with_gate(R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32),
                             GATE)
        out[arch] = (rcfg, rparams, _f32(get_config(arch, "smoke")),
                     params_from_reference(jax.tree.map(np.asarray, rparams), "cpu"))
    return out


def _inputs(cfg, b, s, seed):
    """(B, S) prompts and the arch's memory (``generate``'s extras), numpy."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.cross_attn_every > 0:
        return prompts, {"image_embeds": rng.standard_normal(
            (b, cfg.num_patches, cfg.vision_embed_dim), np.float32)}
    if cfg.is_encdec:
        return prompts, {"src_frames": rng.standard_normal(
            (b, SRC_FRAMES, cfg.audio_embed_dim), np.float32)}
    return prompts, {}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_reference_engine_across_two_batch_sizes(arch, models):
    rcfg, rparams, cfg, params = models[arch]
    ref = RefServeEngine(rcfg, rparams, max_len=MAX_LEN)
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    for i, (b, s) in enumerate(BATCHES):
        prompts, extras = _inputs(cfg, b, s, seed=i)
        want = ref.generate(prompts, max_new_tokens=NEW, extras=extras)
        got = engine.generate(prompts, max_new_tokens=NEW, extras=extras)
        assert got.shape == (b, NEW) and got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"batch {i}")
    assert len(engine.steps) == 2
    assert all(step.graph is None for step in engine.steps.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_no_cache_row_survives_a_batch_and_a_key_keeps_its_buffers(arch, models):
    """Batch A (longer prompts), then batch B of the same size: B's tokens
    are a fresh engine's, and B ran on A's buffers."""
    _, _, cfg, params = models[arch]
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    a, a_extras = _inputs(cfg, 3, 10, seed=5)
    b, b_extras = _inputs(cfg, 3, 7, seed=6)
    engine.generate(a, max_new_tokens=NEW, extras=a_extras)
    (step,) = engine.steps.values()
    buffers = [t.data_ptr() for t in leaves(step.cache) + [step.tok, step.pos, step.out]]
    got = engine.generate(b, max_new_tokens=NEW, extras=b_extras)
    fresh = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(got, fresh.generate(b, max_new_tokens=NEW, extras=b_extras))
    assert list(engine.steps.values()) == [step]
    assert [t.data_ptr() for t in leaves(step.cache) + [step.tok, step.pos, step.out]] == buffers


@pytest.mark.parametrize("arch", ["stablelm-3b", "jamba-1.5-large-398b"])
def test_the_engine_keeps_its_most_recently_used_keys(arch, models):
    """Batch sizes 1 .. ``MAX_DECODE_KEYS``, then 1 again and one more size:
    the least recently used key (B = 2) is dropped, B = 1 keeps its buffers,
    and B = 2 served again gives a fresh engine's tokens."""
    _, _, cfg, params = models[arch]
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")

    def by_size():
        return {key[0]: step for key, step in engine.steps.items()}

    for b in range(1, MAX_DECODE_KEYS + 1):
        engine.generate(_inputs(cfg, b, 6, seed=b)[0], max_new_tokens=NEW)
    one = by_size()[1]
    engine.generate(_inputs(cfg, 1, 6, seed=1)[0], max_new_tokens=NEW)
    engine.generate(_inputs(cfg, MAX_DECODE_KEYS + 1, 6, seed=0)[0], max_new_tokens=NEW)
    assert list(by_size()) == [*range(3, MAX_DECODE_KEYS + 1), 1, MAX_DECODE_KEYS + 1]
    assert by_size()[1] is one
    prompts = _inputs(cfg, 2, 6, seed=2)[0]
    fresh = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(engine.generate(prompts, max_new_tokens=NEW),
                                  fresh.generate(prompts, max_new_tokens=NEW))
    assert len(engine.steps) == MAX_DECODE_KEYS


def test_assigned_params_drop_every_key(models):
    """New weights after a batch: the key built on the old ones is gone,
    and the next batch gives a fresh engine's tokens on the new weights."""
    _, _, cfg, params = models["stablelm-3b"]
    gen = torch.Generator().manual_seed(0)
    other = map_leaves(lambda t: t + 0.1 * torch.randn(t.shape, generator=gen), params)
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    prompts, _ = _inputs(cfg, 3, 7, seed=8)
    before = engine.generate(prompts, max_new_tokens=NEW)
    engine.params = other
    assert not engine.steps
    got = engine.generate(prompts, max_new_tokens=NEW)
    fresh = ServeEngine(cfg, other, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(got, fresh.generate(prompts, max_new_tokens=NEW))
    assert not np.array_equal(got, before)


# mixtral's smoke window is 8: a 10-token prompt leaves a ring buffer that
# the steps wrap round
@pytest.mark.parametrize("arch", ["stablelm-3b", "mixtral-8x7b", "deepseek-v3-671b", "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_step_body_at_a_tensor_position_equals_int_decode_bit_for_bit(arch, models):
    _, _, cfg, params = models[arch]
    prompts, _ = _inputs(cfg, 3, 10, seed=7)
    tokens = torch.from_numpy(prompts).long()
    with torch.inference_mode():
        logits, cache = prefill(params, cfg, {"tokens": tokens}, max_len=MAX_LEN)
        tok = sample_token(logits, 0.0, None)
        step = DecodeStep(make_serve_step(cfg), params, cache, 3, MAX_LEN, False,
                          torch.device("cpu"))
        step.load(cache, tok, 10)
        eager, toks = map_leaves(torch.clone, cache), [tok]
        for pos in range(10, 15):
            want, eager = decode_step(params, cfg, toks[-1], eager, pos)
            toks.append(want[:, -1].argmax(-1, keepdim=True))
            step.run(1)
            assert torch.equal(step.logits, want), pos
            assert torch.equal(step.tok, toks[-1]) and int(step.pos) == pos + 1
        for x, y in zip(leaves(step.cache), leaves(eager), strict=True):
            assert torch.equal(x, y)
        assert torch.equal(step.out[:, 10:16], torch.cat(toks, 1))


def test_gumbel_max_draws_follow_softmax():
    """20,000 draws from a fixed 8-way distribution at T = 0.7: each
    class's share within 4 sigma of softmax(logits / T)."""
    n, t = 20_000, 0.7
    logits = torch.tensor([1.0, 0.2, -0.5, 2.0, 0.0, -1.5, 0.7, 1.2])
    gen = torch.Generator().manual_seed(3)
    draws = sample_token(logits.expand(n, 1, 8), torch.tensor(t), gen)
    assert draws.shape == (n, 1) and draws.dtype == torch.long
    share = torch.bincount(draws[:, 0], minlength=8).double() / n
    p = torch.softmax(logits.double() / t, -1)
    sigma = (p * (1 - p) / n).sqrt()
    assert ((share - p).abs() <= 4 * sigma).all(), (share, p)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card_engine(arch):
    """A smoke f32 engine on the card from seeded weights (gates at 1.0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = _f32(get_config(arch, "smoke"))
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    _set_gates(params, GATE)
    return ServeEngine(cfg, params, max_len=MAX_LEN, device="cuda")


def _eager(engine, prompts, extras, new):
    """Greedy tokens of a prefill and an eager ``decode_step`` loop at int
    positions on the engine's device, and the first step's logits."""
    dev = engine.device
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=dev),
             **{k: torch.as_tensor(v, device=dev) for k, v in extras.items()}}
    s = prompts.shape[1]
    with torch.inference_mode():
        logits, cache = prefill(engine.params, engine.cfg, batch, engine.max_len)
        out, first = [logits[:, -1].argmax(-1, keepdim=True)], None
        for pos in range(s, s + new - 1):
            logits, cache = decode_step(engine.params, engine.cfg, out[-1], cache, pos)
            first = logits.clone() if first is None else first
            out.append(logits[:, -1].argmax(-1, keepdim=True))
    return torch.cat(out, 1).cpu().numpy(), first


def _sync_free_run(monkeypatch):
    """``DecodeStep.run`` under ``set_sync_debug_mode("error")``."""
    run = DecodeStep.run

    def checked(self, steps):
        torch.cuda.set_sync_debug_mode("error")
        try:
            run(self, steps)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(DecodeStep, "run", checked)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_captured_decode_equals_the_eager_loop(arch, monkeypatch):
    engine = _card_engine(arch)
    _sync_free_run(monkeypatch)
    prompts, extras = _inputs(engine.cfg, 4, 10, seed=1)
    want, first = _eager(engine, prompts, extras, NEW)
    engine.generate(prompts, max_new_tokens=2, extras=extras)  # one replay
    (step,) = engine.steps.values()
    assert step.graph is not None
    err = (step.logits - first).abs().max().item()
    assert torch.equal(step.logits, first) or err <= LOGITS_BAR, err
    np.testing.assert_array_equal(engine.generate(prompts, max_new_tokens=NEW, extras=extras), want)
    assert list(engine.steps.values()) == [step]  # one capture for the key
    prompts, extras = _inputs(engine.cfg, 3, 7, seed=2)
    np.testing.assert_array_equal(engine.generate(prompts, max_new_tokens=NEW, extras=extras),
                                  _eager(engine, prompts, extras, NEW)[0])
    assert len(engine.steps) == 2 and all(s.graph is not None for s in engine.steps.values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_seeded_sampling_repeats(arch, monkeypatch):
    engine = _card_engine(arch)
    _sync_free_run(monkeypatch)
    prompts, extras = _inputs(engine.cfg, 4, 10, seed=3)
    a = engine.generate(prompts, max_new_tokens=NEW, temperature=0.8, seed=11, extras=extras)
    b = engine.generate(prompts, max_new_tokens=NEW, temperature=0.8, seed=11, extras=extras)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < engine.cfg.vocab_size)).all()
    c = engine.generate(prompts, max_new_tokens=NEW, temperature=50.0, seed=12, extras=extras)
    assert not np.array_equal(a, c)
    assert len(engine.steps) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_capture_on_a_worker_thread_while_the_main_thread_uses_the_card(arch):
    engine = _card_engine(arch)
    prompts, extras = _inputs(engine.cfg, 4, 10, seed=4)
    want, _ = _eager(engine, prompts, extras, NEW)
    result, stop = {}, threading.Event()

    def worker():
        try:
            result["tokens"] = engine.generate(prompts, max_new_tokens=NEW, extras=extras)
        except Exception as exc:  # noqa: BLE001 - carried to the main thread
            result["error"] = exc
        finally:
            stop.set()

    x = torch.randn(512, 512, device="cuda")
    thread = threading.Thread(target=worker)
    thread.start()
    steps = 0
    while not stop.is_set():
        x = torch.tanh(x @ x)
        steps += 1
    thread.join(timeout=120)
    assert not thread.is_alive()
    torch.cuda.synchronize()
    assert "error" not in result, result.get("error")
    np.testing.assert_array_equal(result["tokens"], want)
    assert steps > 0 and len(engine.steps) == 1


@pytest.mark.cuda
def test_cuda_a_deleted_engine_gives_back_its_memory():
    """Static buffers and graph go with the engine; a second engine's
    captures leave nothing behind either (one capture stream for all)."""
    held = []
    for _ in range(2):
        engine = _card_engine("stablelm-3b")
        prompts, _ = _inputs(engine.cfg, 4, 10, seed=5)
        engine.generate(prompts, max_new_tokens=NEW)
        assert len(engine.steps) == 1
        del engine
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[1] == held[0], held


@pytest.mark.cuda
def test_cuda_a_dropped_key_gives_back_its_memory():
    """Keys of B = 1 .. ``MAX_DECODE_KEYS``, then as many others that push
    them out, then the first ones again: the engine holds what it held the
    first time, so a dropped key's buffers and graph are gone."""
    engine = _card_engine("stablelm-3b")
    held = []
    for first in (1, MAX_DECODE_KEYS + 1, 1):
        for b in range(first, first + MAX_DECODE_KEYS):
            engine.generate(_inputs(engine.cfg, b, 10, seed=b)[0], max_new_tokens=NEW)
        assert sorted(key[0] for key in engine.steps) == list(range(first, first + MAX_DECODE_KEYS))
        assert all(step.graph is not None for step in engine.steps.values())
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[2] == held[0], held
