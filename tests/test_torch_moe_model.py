"""The MoE branch at model level against the reference, on the same
weights (``repro.models.init_params``, moved through numpy), float32:
mixtral (``[attn + moe]``, sliding window 8 at smoke size) and jamba with
experts (MoE on blocks 1, 3, 5, 7 of each group of 8). Spec shapes at
full size (no allocation), logits at atol 5e-3 / rtol 1e-3, the
prefill+decode contract and the ring-buffer long decode of
``tests/test_decode_consistency.py`` (atol 2e-2 and 3e-2 / rtol 1e-3),
and three mixtral train steps against ``jax.jit(make_train_step)``
(AdamW, 1 and 2 microbatches; state at atol 1e-5 / rtol 1e-4, metrics
``moe_lb``/``moe_z`` included at atol 1e-5). At smoke size (cf 2.0)
nothing drops, so decoding is the forward (ROADMAP C16)."""

import dataclasses
import sys
from pathlib import Path

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
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.interop import (
    leaf_names, params_from_reference, params_to_reference, state_from_reference,
    state_to_reference,
)
from repro_torch.models import (
    count_params, decode_step, decoder_layout, forward, model_spec, prefill, spec_shapes,
)
from repro_torch.models import moe as moe_mod
from repro_torch.train.train_step import make_train_step, split_microbatches
from repro_torch.tree import leaves_with_names

ARCHS = ["mixtral-8x7b", "jamba-1.5-large-398b"]
B, S = 2, 16


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def ref_models():
    """(reference cfg, reference params, port cfg, port params) per arch."""
    out = {}
    for arch in ARCHS:
        rcfg = _f32(ref_get_config(arch, "smoke"))
        rparams = R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32)
        out[arch] = (rcfg, rparams, _f32(get_config(arch, "smoke")),
                     params_from_reference(jax.tree.map(np.asarray, rparams), "cpu"))
    return out


def _tokens(cfg, seed=3):
    return SyntheticTokens(cfg, B, S + 2, seed=seed).batch_at(0)["tokens"]


@pytest.mark.parametrize("arch,variant", [
    ("mixtral-8x7b", "full"), ("mixtral-8x7b", "smoke"), ("mixtral-8x7b", "half-depth"),
    ("starcoder2-15b", "full"), ("starcoder2-15b", "smoke"),
    ("qwen2.5-14b", "full"), ("qwen2.5-14b", "smoke"),
])
def test_configs_equal_reference(arch, variant):
    """Every field, ``MoEConfig``'s (aux and z weights, shared experts)
    included; ``half-depth`` is the reference's ``full()`` at 16 layers."""
    want = (ref_get_config(arch, "full").copy(num_layers=16) if variant == "half-depth"
            else ref_get_config(arch, variant))
    assert dataclasses.asdict(get_config(arch, variant)) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch,variant,ref_variant", [
    ("mixtral-8x7b", "full", "full"),
    ("mixtral-8x7b", "half-depth", None),
    ("jamba-1.5-large-398b", "full", "full"),
])
def test_spec_shapes_equal_reference(arch, variant, ref_variant):
    """Shape trees only: nothing is allocated at full size."""
    rcfg = (ref_get_config(arch, ref_variant) if ref_variant
            else ref_get_config(arch, "full").copy(num_layers=16))
    rspec = R.model_spec(rcfg)
    spec = model_spec(get_config(arch, variant))
    is_leaf = lambda x: isinstance(x, RefLeaf)  # noqa: E731
    assert spec_shapes(spec) == jax.tree.map(lambda leaf: leaf.shape, rspec, is_leaf=is_leaf)
    assert count_params(spec) == R.count_params(rspec)
    if variant == "half-depth":
        assert count_params(spec) == 23_482_470_400  # 46.96 GB in bf16


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_roundtrip_carries_moe_leaves(arch, ref_models):
    """The router and the stacked experts cross through numpy as they are,
    in the reference's leaf order."""
    _, rparams, _, params = ref_models[arch]
    paths = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert leaf_names(params) == [jax.tree_util.keystr(p) for p, _ in paths]
    assert any("['router']" in n for n in leaf_names(params))
    for (_, want), got in zip(paths, jax.tree.leaves(params_to_reference(params))):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_is_the_references(arch):
    cfg = get_config(arch, "full")
    ref = R.model.decoder_layout(ref_get_config(arch, "full"))
    layout = decoder_layout(cfg)
    assert [(b.mixer, b.mlp) for b in layout.group] == [(b.mixer, b.mlp) for b in ref.group]
    assert layout.num_groups == ref.num_groups
    moe_blocks = [i for i, b in enumerate(layout.group) if b.mlp == "moe"]
    assert moe_blocks == ([0] if arch == "mixtral-8x7b" else [1, 3, 5, 7])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_and_aux_match_reference(arch, use_pallas, ref_models):
    rcfg, rparams, cfg, params = ref_models[arch]
    tokens = _tokens(cfg)
    want, waux = R.forward(rparams, rcfg.copy(use_pallas=use_pallas),
                           {"tokens": jnp.asarray(tokens)})
    got, aux = forward(params, cfg.copy(use_pallas=use_pallas), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=1e-3)
    for key in ("lb_loss", "z_loss"):
        assert float(aux[key]) == pytest.approx(float(waux[key]), abs=1e-5), key
        assert float(aux[key]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, ref_models):
    """tests/test_decode_consistency.py's contract, on the port, plus the
    decode logits against the reference's decode."""
    rcfg, rparams, cfg, params = ref_models[arch]
    tokens = torch.from_numpy(_tokens(cfg))
    logits, _ = forward(params, cfg, {"tokens": tokens})
    last, cache = prefill(params, cfg, {"tokens": tokens[:, :S]}, max_len=S + 4)
    np.testing.assert_allclose(last.numpy(), logits[:, S - 1 : S].numpy(), atol=2e-2, rtol=1e-3)
    dl, cache = decode_step(params, cfg, tokens[:, S : S + 1], cache, S)
    np.testing.assert_allclose(dl[:, 0].numpy(), logits[:, S].numpy(), atol=2e-2, rtol=1e-3)
    dl2, _ = decode_step(params, cfg, tokens[:, S + 1 : S + 2], cache, S + 1)
    np.testing.assert_allclose(dl2[:, 0].numpy(), logits[:, S + 1].numpy(), atol=3e-2, rtol=1e-3)

    rt = jnp.asarray(tokens.numpy())
    _, rcache = R.prefill(rparams, rcfg, {"tokens": rt[:, :S]}, max_len=S + 4)
    rdl, _ = R.decode_step(rparams, rcfg, rt[:, S : S + 1], rcache, jnp.int32(S))
    _, cache = prefill(params, cfg, {"tokens": tokens[:, :S]}, max_len=S + 4)
    dl, _ = decode_step(params, cfg, tokens[:, S : S + 1], cache, S)
    np.testing.assert_allclose(dl.numpy(), np.asarray(rdl), atol=5e-3, rtol=1e-3)


def test_swa_ring_buffer_long_decode(ref_models):
    """tests/test_decode_consistency.py's mixtral ring buffer: prefill 4
    tokens (under the window of 8), decode one by one to 3x the window;
    each step equals the forward, which equals the reference's."""
    rcfg, rparams, cfg, params = ref_models["mixtral-8x7b"]
    assert cfg.sliding_window == 8
    total = 24
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, total)).astype(np.int32)
    want, _ = R.forward(rparams, rcfg, {"tokens": jnp.asarray(tokens)})
    t = torch.from_numpy(tokens)
    logits, _ = forward(params, cfg, {"tokens": t})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=5e-3, rtol=1e-3)
    _, cache = prefill(params, cfg, {"tokens": t[:, :4]}, max_len=total)
    assert cache["layers"]["b0"]["k"].shape[2] == 8  # the ring holds the window
    for pos in range(4, total):
        dl, cache = decode_step(params, cfg, t[:, pos : pos + 1], cache, pos)
        np.testing.assert_allclose(dl[:, 0].numpy(), logits[:, pos].numpy(), atol=3e-2, rtol=1e-3,
                                   err_msg=f"divergence at pos {pos}")


def test_decode_runs_moe_on_one_token_per_sequence(ref_models, monkeypatch):
    """Decode calls ``moe_fwd`` on (B, 1, d), one call per MoE block."""
    _, _, cfg, params = ref_models["jamba-1.5-large-398b"]
    seen = []
    real = moe_mod.moe_fwd

    def counting(p, x, c):
        out, aux = real(p, x, c)
        seen.append((tuple(x.shape), float(aux["dropped_frac"])))
        return out, aux

    monkeypatch.setattr(moe_mod, "moe_fwd", counting)
    tokens = torch.from_numpy(_tokens(cfg))
    _, cache = prefill(params, cfg, {"tokens": tokens[:, :S]}, max_len=S + 2)
    assert [s for s, _ in seen] == [(B, S, cfg.d_model)] * 4
    seen.clear()
    decode_step(params, cfg, tokens[:, S : S + 1], cache, S)
    assert seen == [((B, 1, cfg.d_model), 0.0)] * 4


def test_chip_smoke_moe_drops_reads_each_call_and_splits_padding(ref_models, monkeypatch):
    """chip_smoke.py's ``MoeDrops`` (a wrapper on the router) records each
    MoE call's dropped share as ``moe_fwd`` returns it, and splits the
    dropped pairs between padded rows and the prompts' own: at cf 0.5
    choices drop, the two parts add up to the whole, and with no padded
    row the prompts' share is the whole share."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)

    _, _, cfg, params = ref_models["jamba-1.5-large-398b"]
    cfg = cfg.copy(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    k = cfg.moe.top_k
    returned = []
    real_fwd = moe_mod.moe_fwd

    def counting(p, x, c):
        out, aux = real_fwd(p, x, c)
        returned.append(float(aux["dropped_frac"]))
        return out, aux

    monkeypatch.setattr(moe_mod, "moe_fwd", counting)
    tokens = torch.from_numpy(_tokens(cfg))[:, :S]
    padded = torch.ones(B, S, dtype=torch.bool)
    padded[0, :5] = False  # as if row 0 were left-padded by 5
    with torch.inference_mode(), chip_smoke.MoeDrops() as drops:
        for mask in (padded, torch.ones(B, S, dtype=torch.bool)):
            prefill(params, cfg, {"tokens": tokens}, max_len=S)
            shares = drops.take()
            on_real, on_pad = drops.split(mask, k)
            assert shares == returned and len(shares) == 4 and min(shares) > 0
            n_real = int(mask.sum())
            for share, r, p in zip(shares, on_real, on_pad):
                dropped = share * k * B * S
                assert r * k * n_real + p * dropped == pytest.approx(dropped, abs=1e-3)
            returned.clear()
    assert on_pad == [0.0] * 4 and on_real == pytest.approx(shares, abs=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_over_three_steps(microbatches, ref_models):
    rcfg, rparams, cfg, _ = ref_models["mixtral-8x7b"]
    kw = dict(optimizer="adamw", learning_rate=1e-3, warmup_steps=1, total_steps=10,
              microbatches=microbatches)
    rt, tt = RefTrainConfig(**kw), TrainConfig(**kw)
    rstate = ref_init_state(rparams, rt)
    state = state_from_reference(jax.tree.map(np.asarray, rstate))
    ref_step = jax.jit(ref_make_train_step(rcfg, rt))
    step = make_train_step(cfg, tt)
    data = SyntheticTokens(rcfg, 4, 16, seed=1)
    for i in range(3):
        host = data.batch_at(i)
        if microbatches > 1:
            host = split_microbatches(host, microbatches)
        rstate, rmetrics = ref_step(rstate, {k: jnp.asarray(v) for k, v in host.items()})
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in host.items()})
        assert sorted(metrics) == sorted(rmetrics)
        assert {"moe_lb", "moe_z"} <= set(metrics)
        for key in rmetrics:
            assert float(metrics[key]) == pytest.approx(float(rmetrics[key]), abs=1e-5), key
    assert int(state["step"]) == int(rstate["step"]) == 3
    got = leaves_with_names(state_to_reference(state))
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)
