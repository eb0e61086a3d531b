"""deepseek-v3 at model level against the reference, on the same weights
(``repro.models.init_params``, moved through numpy), float32 at smoke
size: MLA blocks, the dense prefix (``prefix_groups``, one layer at smoke
size) and the MTP block. Configs and spec shape trees for ``full``,
``smoke`` and ``two-moe`` (no allocation), logits and aux at atol 5e-3 /
rtol 1e-3 for both ``use_pallas`` settings, ``return_hidden`` and
``mtp_logits``, the prefill+decode contract of
``tests/test_decode_consistency.py`` (atol 2e-2 and 3e-2 / rtol 1e-3), the
prefix cache grown by ``pad_cache``, and train steps with ``mtp_ce``
against ``jax.jit(make_train_step)`` (AdamW; 1 and 2 microbatches, remat
"full" and "dots"; state at atol 1e-5 / rtol 1e-4, metrics at atol
1e-5)."""

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
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import loss_fn as ref_loss_fn
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.interop import (
    leaf_names, params_from_reference, params_to_reference, state_from_reference,
    state_to_reference,
)
from repro_torch.models import (
    count_params, decode_step, decoder_layout, forward, model_spec, mtp_logits, pad_cache,
    prefill, spec_shapes,
)
from repro_torch.models.model import prefix_layout
from repro_torch.train.train_step import loss_fn, make_train_step, split_microbatches
from repro_torch.tree import leaves_with_names

ARCH = "deepseek-v3-671b"
B, S = 2, 16
TWO_MOE_PARAMS = 26_952_316_928  # 53.90 GB in bf16


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params), smoke, f32."""
    rcfg = _f32(ref_get_config(ARCH, "smoke"))
    rparams = R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32)
    return (rcfg, rparams, _f32(get_config(ARCH, "smoke")),
            params_from_reference(jax.tree.map(np.asarray, rparams), "cpu"))


def _tokens(cfg, seed=3):
    return SyntheticTokens(cfg, B, S + 2, seed=seed).batch_at(0)["tokens"]


def _ref_cfg(variant):
    if variant == "two-moe":
        return ref_get_config(ARCH, "full").copy(num_layers=2)
    return ref_get_config(ARCH, variant)


@pytest.mark.parametrize("variant", ["full", "smoke", "two-moe"])
def test_config_and_spec_shapes_equal_reference(variant):
    """Every field (``MLAConfig``'s, the prefix's and MTP's included), and
    the shape tree: nothing is allocated at full size."""
    rcfg, cfg = _ref_cfg(variant), get_config(ARCH, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    rspec = R.model_spec(rcfg)
    spec = model_spec(cfg)
    is_leaf = lambda x: isinstance(x, RefLeaf)  # noqa: E731
    assert spec_shapes(spec) == jax.tree.map(lambda leaf: leaf.shape, rspec, is_leaf=is_leaf)
    assert count_params(spec) == R.count_params(rspec)
    assert {"prefix_groups", "mtp"} <= set(spec)
    if variant == "two-moe":
        assert count_params(spec) == TWO_MOE_PARAMS
    if variant == "full":
        assert count_params(spec) == 671_360_333_824


def test_layouts_are_the_references():
    cfg, rcfg = get_config(ARCH, "full"), ref_get_config(ARCH, "full")
    for ours, ref in ((decoder_layout(cfg), R.model.decoder_layout(rcfg)),
                      (prefix_layout(cfg), R.model.prefix_layout(rcfg))):
        assert [(b.mixer, b.mlp) for b in ours.group] == [(b.mixer, b.mlp) for b in ref.group]
        assert ours.num_groups == ref.num_groups
    assert [(b.mixer, b.mlp) for b in decoder_layout(cfg).group] == [("mla", "moe")]
    assert prefix_layout(cfg).num_groups == 3


def test_interop_roundtrip_carries_prefix_and_mtp(model):
    _, rparams, _, params = model
    paths = jax.tree_util.tree_flatten_with_path(rparams)[0]
    names = leaf_names(params)
    assert names == [jax.tree_util.keystr(p) for p, _ in paths]
    assert any(n.startswith("['prefix_groups']") for n in names)
    assert any(n.startswith("['mtp']['block']['mixer']['wk_b']") for n in names)
    for (_, want), got in zip(paths, jax.tree.leaves(params_to_reference(params))):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_aux_hidden_and_mtp_match_reference(use_pallas, model):
    rcfg, rparams, cfg, params = model
    tokens = _tokens(cfg)
    rc, c = rcfg.copy(use_pallas=use_pallas), cfg.copy(use_pallas=use_pallas)
    want, waux, whidden = R.forward(rparams, rc, {"tokens": jnp.asarray(tokens)},
                                    return_hidden=True)
    t = torch.from_numpy(tokens)
    got, aux, hidden = forward(params, c, {"tokens": t}, return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(whidden), atol=5e-3, rtol=1e-3)
    for key in ("lb_loss", "z_loss"):
        assert float(aux[key]) == pytest.approx(float(waux[key]), abs=1e-5), key
        assert float(aux[key]) > 0
    wm = R.mtp_logits(rparams, rc, whidden, jnp.asarray(tokens))
    m = mtp_logits(params, c, hidden, t)
    assert m.shape == (B, S + 1, cfg.vocab_size)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm), atol=5e-3, rtol=1e-3)


def test_prefill_decode_matches_forward(model):
    """tests/test_decode_consistency.py's contract on the port, plus the
    decode logits against the reference's decode."""
    rcfg, rparams, cfg, params = model
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


def test_pad_cache_grows_the_prefix_layers(model):
    """A prefill to ``max_len`` > S grows the prefix layers' latent caches
    (``prefix_layers``) as the reference's ``pad_cache`` does, so decode
    writes slots past S in every layer (ROADMAP C18); three decode steps
    match the reference's."""
    rcfg, rparams, cfg, params = model
    tokens = torch.from_numpy(_tokens(cfg))
    max_len = S + 8
    _, cache = prefill(params, cfg, {"tokens": tokens[:, :S]}, max_len=max_len)
    rt = jnp.asarray(tokens.numpy())
    _, rcache = R.prefill(rparams, rcfg, {"tokens": rt[:, :S]}, max_len=max_len)
    got = {k: tuple(v.shape) for k, v in leaves_with_names(
        {"layers": cache["layers"], "prefix_layers": cache["prefix_layers"]})}
    rleaves = jax.tree_util.tree_flatten_with_path(
        {"layers": rcache["layers"], "prefix_layers": rcache["prefix_layers"]})[0]
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in rleaves}
    assert got == want
    assert got["['prefix_layers']['b0']['c_kv']"] == (1, B, max_len, cfg.mla.kv_lora_rank)
    assert got["['prefix_layers']['b0']['k_rope']"] == (1, B, max_len, cfg.mla.qk_rope_head_dim)
    # pad_cache on a prefill's unpadded cache gives the same shapes
    _, unpadded = forward(params, cfg, {"tokens": tokens[:, :S]}, return_cache=True)[1:]
    assert unpadded["prefix_layers"]["b0"]["c_kv"].shape[2] == S
    assert pad_cache(unpadded, cfg, max_len)["prefix_layers"]["b0"]["c_kv"].shape[2] == max_len
    # decode three steps: the third writes slot S + 2 of every layer's cache
    for pos in range(S, S + 3):
        tok = tokens[:, min(pos, S + 1) : min(pos, S + 1) + 1]
        dl, cache = decode_step(params, cfg, tok, cache, pos)
        rdl, rcache = R.decode_step(rparams, rcfg, jnp.asarray(tok.numpy()), rcache,
                                    jnp.int32(pos))
        np.testing.assert_allclose(dl.numpy(), np.asarray(rdl), atol=5e-3, rtol=1e-3,
                                   err_msg=f"pos {pos}")
    assert cache["prefix_layers"]["b0"]["c_kv"][:, :, S + 2].abs().sum() > 0


def test_loss_fn_reports_mtp_ce_as_the_reference(model):
    rcfg, rparams, cfg, params = model
    tokens = _tokens(cfg)
    tc, rtc = TrainConfig(), RefTrainConfig()
    wloss, wmetrics = ref_loss_fn(rparams, rcfg, rtc, {"tokens": jnp.asarray(tokens)})
    loss, metrics = loss_fn(params, cfg, tc, {"tokens": torch.from_numpy(tokens)})
    assert sorted(metrics) == sorted(wmetrics) == ["ce", "loss", "moe_lb", "moe_z", "mtp_ce"]
    for key in wmetrics:
        assert float(metrics[key]) == pytest.approx(float(wmetrics[key]), abs=1e-5), key
    want = (metrics["ce"] + 0.01 * metrics["moe_lb"] + 1e-3 * metrics["moe_z"]
            + tc.mtp_loss_weight * metrics["mtp_ce"])
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    assert float(loss) == pytest.approx(float(wloss), abs=1e-5)


@pytest.mark.parametrize("microbatches,remat", [(1, "full"), (2, "full"), (1, "dots")])
def test_train_step_with_mtp_matches_reference(microbatches, remat, model):
    rcfg, rparams, cfg, _ = model
    rcfg, cfg = rcfg.copy(remat=remat), cfg.copy(remat=remat)
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
        assert {"moe_lb", "moe_z", "mtp_ce"} <= set(metrics)
        for key in rmetrics:
            assert float(metrics[key]) == pytest.approx(float(rmetrics[key]), abs=1e-5), key
    got = leaves_with_names(state_to_reference(state))
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)
