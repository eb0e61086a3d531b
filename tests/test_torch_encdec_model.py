"""llama-3.2-vision (tanh-gated cross-attention over image embeddings) and
seamless-m4t (a bidirectional encoder, and a decoder that cross-attends
to its output) at model level against the reference, on the same weights
(``repro.models.init_params``, moved through numpy), float32 at smoke
size, with every cross-attention ``gate`` set to 1.0 in both packages (at
the reference's init of 0 the memory never reaches the logits, which the
last test shows). Configs and spec shape trees for ``full`` and ``smoke``
(no allocation), logits at atol 5e-3 / rtol 1e-3 for both ``use_pallas``
settings, with a control: another memory moves the logits outside that
bar; the prefill+decode contract of ``tests/test_decode_consistency.py``
(atol 2e-2 and 3e-2 / rtol 1e-3); ``pad_cache`` leaving ``xk``/``xv`` and
``memory`` at the memory's length; greedy ``generate`` with ``extras``;
the ``ValueError`` for a missing memory (ROADMAP C19); and train steps
against ``jax.jit(make_train_step)`` (AdamW and Adafactor; 1 and 2
microbatches, remat "full" and "dots"; state at atol 1e-5 / rtol 1e-4,
metrics at atol 1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import SyntheticTokens
from repro.models.sharding import ParamLeaf as RefLeaf
from repro.serve.engine import ServeEngine as RefServeEngine
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.interop import (
    leaf_names, params_from_reference, params_to_reference, state_from_reference,
    state_to_reference,
)
from repro_torch.models import (
    count_params, decode_step, decoder_layout, forward, model_spec, pad_cache, prefill,
    spec_shapes,
)
from repro_torch.models.model import decoder_with_cross_layout, encoder_layout, main_layout
from repro_torch.runtime.store import MemoryStore
from repro_torch.serve.batcher import make_batch_handler
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.train_step import make_train_step, split_microbatches
from repro_torch.tree import leaves_with_names

VISION, SEAMLESS = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
ARCHS = [VISION, SEAMLESS]
MEMORY_KEY = {VISION: "image_embeds", SEAMLESS: "src_frames"}
FULL_PARAMS = {VISION: 9_729_019_912, SEAMLESS: 1_633_304_600}  # 19.46 and 3.27 GB in bf16
GATE = 1.0  # tanh(1.0) = 0.762
B, S = 2, 16


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


def _with_gate(tree, value):
    if isinstance(tree, dict):
        return {k: jnp.full_like(v, value) if k == "gate" else _with_gate(v, value)
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference cfg, reference params, port cfg, port params),
    smoke, f32, every gate at ``GATE``."""
    out = {}
    for arch in ARCHS:
        rcfg = _f32(ref_get_config(arch, "smoke"))
        rparams = _with_gate(R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32),
                             GATE)
        out[arch] = (rcfg, rparams, _f32(get_config(arch, "smoke")),
                     params_from_reference(jax.tree.map(np.asarray, rparams), "cpu"))
    return out


def _batch(cfg, seed=3):
    """tokens (B, S + 2) and the arch's memory, numpy."""
    return SyntheticTokens(cfg, B, S + 2, seed=seed).batch_at(0)


def _torch(host):
    return {k: torch.from_numpy(v) for k, v in host.items()}


def _jax(host):
    return {k: jnp.asarray(v) for k, v in host.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_and_spec_shapes_equal_reference(arch, variant):
    rcfg, cfg = ref_get_config(arch, variant), get_config(arch, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    rspec, spec = R.model_spec(rcfg), model_spec(cfg)
    is_leaf = lambda x: isinstance(x, RefLeaf)  # noqa: E731
    assert spec_shapes(spec) == jax.tree.map(lambda leaf: leaf.shape, rspec, is_leaf=is_leaf)
    assert count_params(spec) == R.count_params(rspec)
    if variant == "full":
        assert count_params(spec) == FULL_PARAMS[arch]


def test_layouts_are_the_references():
    def kinds(layout):
        return [(b.mixer, b.mlp, b.causal) for b in layout.group], layout.num_groups

    vcfg, rv = get_config(VISION), ref_get_config(VISION)
    assert kinds(decoder_layout(vcfg)) == kinds(R.model.decoder_layout(rv))
    assert kinds(main_layout(vcfg)) == ([("xattn", "dense", True)]
                                        + [("attn", "dense", True)] * 4, 8)
    scfg, rs = get_config(SEAMLESS), ref_get_config(SEAMLESS)
    assert kinds(encoder_layout(scfg)) == kinds(R.model.encoder_layout(rs))
    assert kinds(encoder_layout(scfg)) == ([("attn", "dense", False)], 24)
    assert kinds(decoder_with_cross_layout(scfg)) == kinds(R.model.decoder_with_cross_layout(rs))
    assert kinds(main_layout(scfg)) == ([("attn_x", "dense", True)], 24)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_roundtrip_carries_gates_and_encoder(arch, models):
    _, rparams, _, params = models[arch]
    paths = jax.tree_util.tree_flatten_with_path(rparams)[0]
    names = leaf_names(params)
    assert names == [jax.tree_util.keystr(p) for p, _ in paths]
    gate = "['groups']['b0']['mixer']['gate']" if arch == VISION else "['groups']['b0']['xattn']['gate']"
    assert gate in names
    if arch == SEAMLESS:
        assert "['encoder']['proj']" in names and "['groups']['b0']['norm_x']['bias']" in names
    for (_, want), got in zip(paths, jax.tree.leaves(params_to_reference(params))):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference_and_see_the_memory(arch, use_pallas, models):
    """The logits at the bar; as a control, the port's logits on another
    memory (the two rows' memories swapped) fall outside it, so the
    comparison sees the memory."""
    rcfg, rparams, cfg, params = models[arch]
    host = _batch(cfg)
    rc, c = rcfg.copy(use_pallas=use_pallas), cfg.copy(use_pallas=use_pallas)
    want, _ = R.forward(rparams, rc, _jax(host))
    got, aux = forward(params, c, _torch(host))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=1e-3)
    assert float(aux["lb_loss"]) == 0.0
    key = MEMORY_KEY[arch]
    other = dict(_torch(host), **{key: torch.from_numpy(host[key][::-1].copy())})
    moved, _ = forward(params, c, other)
    assert not np.allclose(moved.numpy(), np.asarray(want), atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, models):
    """tests/test_decode_consistency.py's contract on the port, plus the
    decode logits against the reference's decode."""
    rcfg, rparams, cfg, params = models[arch]
    host = _batch(cfg)
    batch = _torch(host)
    tokens = batch["tokens"]
    logits, _ = forward(params, cfg, batch)
    pre = dict(batch, tokens=tokens[:, :S])
    last, cache = prefill(params, cfg, pre, max_len=S + 4)
    np.testing.assert_allclose(last.numpy(), logits[:, S - 1 : S].numpy(), atol=2e-2, rtol=1e-3)
    dl, cache = decode_step(params, cfg, tokens[:, S : S + 1], cache, S)
    np.testing.assert_allclose(dl[:, 0].numpy(), logits[:, S].numpy(), atol=2e-2, rtol=1e-3)
    dl2, _ = decode_step(params, cfg, tokens[:, S + 1 : S + 2], cache, S + 1)
    np.testing.assert_allclose(dl2[:, 0].numpy(), logits[:, S + 1].numpy(), atol=3e-2, rtol=1e-3)

    rbatch = _jax(host)
    _, rcache = R.prefill(rparams, rcfg, dict(rbatch, tokens=rbatch["tokens"][:, :S]),
                          max_len=S + 4)
    rdl, _ = R.decode_step(rparams, rcfg, rbatch["tokens"][:, S : S + 1], rcache, jnp.int32(S))
    _, cache = prefill(params, cfg, pre, max_len=S + 4)
    dl, _ = decode_step(params, cfg, tokens[:, S : S + 1], cache, S)
    np.testing.assert_allclose(dl.numpy(), np.asarray(rdl), atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_cache_leaves_the_memory_unpadded(arch, models):
    """A prefill to ``max_len`` grows the self-attention's k/v only: the
    cross-attention's ``xk``/``xv`` and ``memory`` keep the memory's
    length M, as in the reference's cache."""
    rcfg, rparams, cfg, params = models[arch]
    host = _batch(cfg)
    batch = _torch(host)
    max_len = S + 8
    pre = dict(batch, tokens=batch["tokens"][:, :S])
    _, cache = prefill(params, cfg, pre, max_len=max_len)
    rbatch = _jax(host)
    _, rcache = R.prefill(rparams, rcfg, dict(rbatch, tokens=rbatch["tokens"][:, :S]),
                          max_len=max_len)
    got = {k: tuple(v.shape) for k, v in leaves_with_names(cache)}
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(rcache)[0]}
    assert got == want
    m = host[MEMORY_KEY[arch]].shape[1]
    xk = cache["layers"]["b0"]["xk"]
    assert xk.shape[2] == m and cache["memory"].shape[1] == m
    if arch == SEAMLESS:  # the decoder's self-attention cache grew
        assert cache["layers"]["b0"]["k"].shape[2] == max_len
        assert cache["memory"].shape[2] == cfg.d_model  # the encoder's output
    else:
        assert cache["layers"]["b1"]["k"].shape[2] == max_len
    _, _, unpadded = forward(params, cfg, pre, return_cache=True)
    padded = pad_cache(unpadded, cfg, max_len)
    assert padded["layers"]["b0"]["xk"].shape == xk.shape
    assert padded["memory"] is unpadded["memory"]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_with_extras_matches_reference(arch, models):
    """Greedy tokens of ``ServeEngine.generate(..., extras=...)``, the
    reference's only way to serve these models (C19)."""
    rcfg, rparams, cfg, params = models[arch]
    host = _batch(cfg)
    key = MEMORY_KEY[arch]
    prompts = host["tokens"][:, :8]
    want = RefServeEngine(rcfg, rparams, max_len=16).generate(
        prompts, max_new_tokens=6, extras={key: host[key]})
    engine = ServeEngine(cfg, params, max_len=16, device="cpu")
    got = engine.generate(prompts, max_new_tokens=6, extras={key: host[key]})
    np.testing.assert_array_equal(got, np.asarray(want))
    again = engine.generate(prompts, max_new_tokens=6, extras={key: torch.from_numpy(host[key])})
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_missing_memory_raises_value_error_naming_the_key(arch, models):
    """ROADMAP C19: the reference's batch handler passes no ``extras``, and
    its forward then raises a bare ``KeyError``; the port raises
    ``ValueError`` naming the key, through the engine and the handler too."""
    rcfg, rparams, cfg, params = models[arch]
    tokens = _batch(cfg)["tokens"][:, :8]
    key = MEMORY_KEY[arch]
    with pytest.raises(KeyError):
        R.forward(rparams, rcfg, {"tokens": jnp.asarray(tokens)})
    with pytest.raises(ValueError, match=key):
        forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    engine = ServeEngine(cfg, params, max_len=16, device="cpu")
    with pytest.raises(ValueError, match=key):
        engine.generate(tokens, max_new_tokens=2)
    handler = make_batch_handler(engine, MemoryStore(), "serve")
    with pytest.raises(ValueError, match=key):
        handler(None, packed_args=[{"request_id": "r0", "prompt": [1, 2, 3],
                                    "max_new_tokens": 2}])


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_never_reaches_the_logits_at_the_reference_init(arch, models):
    """Why every check here sets the gate: with ``gate`` at its init of 0,
    llama-vision's logits are the same for any memory, and seamless's
    decoder ignores its encoder entirely."""
    _, _, cfg, params = models[arch]
    ungated = _with_gate_torch(params, 0.0)
    host = _batch(cfg)
    key = MEMORY_KEY[arch]
    a, _ = forward(ungated, cfg, _torch(host))
    b, _ = forward(ungated, cfg, dict(_torch(host), **{key: torch.zeros(host[key].shape)}))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _with_gate_torch(tree, value):
    if isinstance(tree, dict):
        return {k: torch.full_like(v, value) if k == "gate" else _with_gate_torch(v, value)
                for k, v in tree.items()}
    return tree


# (arch, microbatches, remat, optimizer). llama-vision at 1 microbatch runs
# Adafactor: under AdamW one element of 14,336 in the cross-attention
# block's w_gate has gradients of about 1e-7 (the leaf's largest is 0.15)
# whose float32 rounding (about 1e-9, 2% of them) AdamW's elementwise
# m / sqrt(v) turns into a 1.5e-5 difference in the parameter. Against a
# float64 run of the port, the reference's float32 gradients are as far off
# as the port's (summed over all leaves, 2.12e-3 and 2.15e-3), so that
# element measures the rounding, not the port; Adafactor's factored second
# moment does not scale an element's step by its own magnitude.
TRAIN_CASES = [(VISION, 1, "full", "adafactor"), (VISION, 2, "full", "adamw"),
               (SEAMLESS, 1, "full", "adamw"), (SEAMLESS, 2, "dots", "adamw")]


@pytest.mark.parametrize("arch,microbatches,remat,optimizer", TRAIN_CASES)
def test_train_step_matches_reference(arch, microbatches, remat, optimizer, models):
    """The memory rides through ``loss_fn``, the microbatch split and both
    remat modes; the gates, the cross-attention's weights and seamless's
    encoder all train."""
    rcfg, rparams, cfg, _ = models[arch]
    rcfg, cfg = rcfg.copy(remat=remat), cfg.copy(remat=remat)
    kw = dict(optimizer=optimizer, learning_rate=1e-3, warmup_steps=1, total_steps=10,
              microbatches=microbatches)
    rt, tt = RefTrainConfig(**kw), TrainConfig(**kw)
    rstate = ref_init_state(rparams, rt)
    state = state_from_reference(jax.tree.map(np.asarray, rstate))
    ref_step = jax.jit(ref_make_train_step(rcfg, rt))
    step = make_train_step(cfg, tt)
    data = SyntheticTokens(rcfg, 4, 16, seed=1)
    for i in range(3):
        host = data.batch_at(i)
        assert MEMORY_KEY[arch] in host
        if microbatches > 1:
            host = split_microbatches(host, microbatches)
        rstate, rmetrics = ref_step(rstate, _jax(host))
        state, metrics = step(state, _torch(host))
        assert sorted(metrics) == sorted(rmetrics)
        for key in rmetrics:
            assert float(metrics[key]) == pytest.approx(float(rmetrics[key]), abs=1e-5), key
    got = leaves_with_names(state_to_reference(state))
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)
    moved = dict(got)
    start = dict(leaves_with_names(params_to_reference(models[arch][3])))
    for name in moved:
        if name.startswith("['params']") and ("gate" in name or "['encoder']['proj']" in name):
            assert not np.array_equal(moved[name], start[name[len("['params']"):]]), name
