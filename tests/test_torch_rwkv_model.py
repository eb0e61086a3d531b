"""Port parity for RWKV-6 (rwkv6-7b smoke config, float32): specs and
init, the time- and channel-mix layers, the model's forward, prefill and
decode, and greedy serving, against the reference on the same weights
(``repro.models.init_params``, moved through numpy). The reference inits
``u``, ``mu`` and ``mu_x`` to zeros, which would leave the bonus and the
mix paths untested, so both sides get the same seeded values instead."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import rwkv as ref_rwkv
from repro.models.sharding import ParamLeaf as RefLeaf
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.interop import leaf_names, params_from_reference
from repro_torch.models import (
    count_params, decode_step, forward, init_params, model_spec, prefill, spec_shapes,
)
from repro_torch.models import layers
from repro_torch.models import rwkv
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import leaves_with_names

ARCH = "rwkv6-7b"
B, S = 2, 16
ATOL, RTOL = 5e-3, 1e-3  # model-level bar of tests/test_kernels.py


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def ref_model():
    """(reference cfg, reference params, port cfg, port params), built once."""
    rcfg = _f32(ref_get_config(ARCH, "smoke"))
    np_tree = jax.tree.map(np.asarray, R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32))
    rng = np.random.default_rng(42)
    mixer = np_tree["groups"]["b0"]["mixer"]
    mixer["u"] = (rng.standard_normal(mixer["u"].shape) * 0.5).astype(np.float32)
    mixer["mu"] = rng.uniform(0.0, 1.0, mixer["mu"].shape).astype(np.float32)
    mixer["mu_x"] = rng.uniform(0.0, 1.0, mixer["mu_x"].shape).astype(np.float32)
    cm = np_tree["groups"]["b0"]["mlp"]
    cm["mu_k"] = rng.uniform(0.0, 1.0, cm["mu_k"].shape).astype(np.float32)
    cm["mu_r"] = rng.uniform(0.0, 1.0, cm["mu_r"].shape).astype(np.float32)
    rparams = jax.tree.map(jnp.asarray, np_tree)
    return rcfg, rparams, _f32(get_config(ARCH, "smoke")), params_from_reference(np_tree, "cpu")


def _tokens(cfg, t, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, t)).astype(np.int32)


def _layer0(params, name):
    """Layer 0's parameters of one sub-block, as numpy-backed trees."""
    return jax.tree.map(lambda p: p[0], params["groups"]["b0"][name])


# ---------------------------------------------------------------------------
# Configs, specs, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_config_spec_and_leaf_names_equal_reference(variant):
    rcfg, cfg = ref_get_config(ARCH, variant), get_config(ARCH, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    rspec, spec = R.model_spec(rcfg), model_spec(cfg)
    is_leaf = lambda x: isinstance(x, RefLeaf)  # noqa: E731
    assert spec_shapes(spec) == jax.tree.map(lambda leaf: leaf.shape, rspec, is_leaf=is_leaf)
    assert count_params(spec) == R.count_params(rspec)
    paths = jax.tree_util.tree_flatten_with_path(rspec, is_leaf=is_leaf)[0]
    assert leaf_names(spec) == [jax.tree_util.keystr(p) for p, _ in paths]
    if variant == "full":
        assert count_params(spec) == 7_577_018_368


def test_w0_custom_init_is_tiled_over_layers_as_the_reference():
    rcfg, cfg = _f32(ref_get_config(ARCH, "smoke")), _f32(get_config(ARCH, "smoke"))
    want = R.init_params(jax.random.key(1), R.model_spec(rcfg), jnp.float32)
    got = init_params(model_spec(cfg), torch.Generator().manual_seed(1), torch.float32, "cpu")
    w0 = got["groups"]["b0"]["mixer"]["w0"]
    assert w0.shape == (cfg.num_layers, cfg.d_model)
    np.testing.assert_allclose(w0.numpy(), np.asarray(want["groups"]["b0"]["mixer"]["w0"]),
                               atol=1e-6, rtol=1e-6)
    assert w0[0, 0] == -6.0 and abs(w0[0, -1].item() + 1.0) < 1e-6


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_group_norm_heads_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 3 + 1
    scale, bias = rng.standard_normal((2, 64)).astype(np.float32)
    want = ref_layers.group_norm_heads(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = layers.group_norm_heads(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.shape == (2, 5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _hidden(cfg, t=12, seed=4):
    return np.random.default_rng(seed).standard_normal((B, t, cfg.d_model)).astype(np.float32)


def test_ddlerp_and_decay_match_reference(ref_model):
    rcfg, rparams, cfg, params = ref_model
    x, xs = _hidden(cfg), _hidden(cfg, seed=5)
    rp, p = _layer0(rparams, "mixer"), _layer0(params, "mixer")
    want = ref_rwkv._ddlerp(rp, jnp.asarray(x), jnp.asarray(xs))
    got = rwkv._ddlerp(p, torch.from_numpy(x), torch.from_numpy(xs))
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-5, rtol=1e-5)
    # decay: in float32, clipped to (-12, 4) before the exp; exercise both ends
    xw = np.concatenate([x, x * 400.0], axis=1)
    want_w = ref_rwkv._decay(rp, jnp.asarray(xw))
    got_w = rwkv._decay(p, torch.from_numpy(xw))
    assert got_w.dtype == torch.float32
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-5, rtol=1e-5)
    assert got_w.min() >= -np.exp(4.0) * (1 + 1e-6) and got_w.max() <= -np.exp(-12.0) * (1 - 1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(use_pallas, with_state, ref_model):
    rcfg, rparams, cfg, params = ref_model
    rcfg, cfg = rcfg.copy(use_pallas=use_pallas), cfg.copy(use_pallas=use_pallas)
    x = _hidden(cfg, t=24)
    rp, p = _layer0(rparams, "mixer"), _layer0(params, "mixer")
    rng = np.random.default_rng(6)
    h, hs = cfg.num_heads, cfg.rwkv.head_size
    state = None
    if with_state:
        state = {"wkv": rng.standard_normal((B, h, hs, hs)).astype(np.float32),
                 "x_prev": rng.standard_normal((B, cfg.d_model)).astype(np.float32)}
    want_y, want_c = ref_rwkv.rwkv_time_mix_fwd(
        rp, jnp.asarray(x), rcfg, chunk=8, return_cache=True,
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    got_y, got_c = rwkv.rwkv_time_mix_fwd(
        p, torch.from_numpy(x), cfg, chunk=8, return_cache=True,
        state=None if state is None else {k: torch.from_numpy(v) for k, v in state.items()})
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    assert set(got_c) == set(want_c) == {"wkv", "x_prev"}
    for k in got_c:
        np.testing.assert_allclose(got_c[k].numpy(), np.asarray(want_c[k]), atol=1e-5, rtol=1e-5)


def test_channel_mix_matches_reference(ref_model):
    rcfg, rparams, cfg, params = ref_model
    x = _hidden(cfg)
    x_prev = np.random.default_rng(7).standard_normal((B, cfg.d_model)).astype(np.float32)
    rp, p = _layer0(rparams, "mlp"), _layer0(params, "mlp")
    for state in (None, x_prev):
        want, want_c = ref_rwkv.rwkv_channel_mix_fwd(
            rp, jnp.asarray(x), rcfg, return_cache=True,
            state=None if state is None else {"x_prev": jnp.asarray(state)})
        got, got_c = rwkv.rwkv_channel_mix_fwd(
            p, torch.from_numpy(x), cfg, return_cache=True,
            state=None if state is None else {"x_prev": torch.from_numpy(state)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got_c["x_prev"].numpy(), np.asarray(want_c["x_prev"]))


@pytest.mark.parametrize("t,chunk", [(32, 8), (30, 30), (25, 25), (37, 1)])
def test_wkv_chunked_xla_path_matches_reference(t, chunk):
    rng = np.random.default_rng(t)
    b, h, k = 2, 2, 8
    r, kk, v = (rng.standard_normal((b, t, h, k)).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.standard_normal((b, t, h, k))).astype(np.float32)
    u = rng.standard_normal((h, k)).astype(np.float32)
    s0 = rng.standard_normal((b, h, k, k)).astype(np.float32)
    arrays = (r, kk, v, lw, u, s0)
    want_o, want_s = ref_rwkv._wkv_chunked(*(jnp.asarray(a) for a in arrays), chunk)
    got_o, got_s = rwkv._wkv_chunked(*(torch.from_numpy(a) for a in arrays), chunk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("t,chunk", [(300, 30), (200, 25), (293, 1), (37, 1), (16, 16), (64, 32)])
def test_chunk_rule_is_the_references(t, chunk):
    assert rwkv.wkv_chunk(t) == chunk


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("t", [S + 2, 37])  # 37 is prime: the WKV runs chunk 1
def test_forward_logits_match_reference(use_pallas, t, ref_model):
    rcfg, rparams, cfg, params = ref_model
    tokens = _tokens(cfg, t)
    want, _ = R.forward(rparams, rcfg.copy(use_pallas=use_pallas), {"tokens": jnp.asarray(tokens)})
    got, aux = forward(params, cfg.copy(use_pallas=use_pallas), {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, t, cfg.vocab_size) and set(aux) == {"lb_loss", "z_loss"}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_forward_cache_stacks_nested_block_caches(ref_model):
    """The RWKV block cache is nested ({"wkv", "x_prev", "cm": {"x_prev"}});
    it is stacked leaf by leaf into the reference's structure."""
    rcfg, rparams, cfg, params = ref_model
    tokens = _tokens(cfg, S)
    _, _, want = R.forward(rparams, rcfg, {"tokens": jnp.asarray(tokens)}, return_cache=True)
    _, _, got = forward(params, cfg, {"tokens": torch.from_numpy(tokens)}, return_cache=True)
    want_leaves = jax.tree_util.tree_flatten_with_path(want["layers"])[0]
    assert leaf_names(got["layers"]) == [jax.tree_util.keystr(p) for p, _ in want_leaves]
    assert got["memory"] is None
    for (_, w), (_, g) in zip(want_leaves, leaves_with_names(got["layers"])):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3)


def test_prefill_decode_matches_forward(ref_model):
    """tests/test_decode_consistency.py's contract, on the port, plus the
    decode logits against the reference's decode."""
    rcfg, rparams, cfg, params = ref_model
    tokens = torch.from_numpy(_tokens(cfg, S + 2))
    logits, _ = forward(params, cfg, {"tokens": tokens})
    last, cache = prefill(params, cfg, {"tokens": tokens[:, :S]}, max_len=S + 4)
    np.testing.assert_allclose(last.numpy(), logits[:, S - 1 : S].numpy(), atol=2e-2, rtol=1e-3)
    dl, cache = decode_step(params, cfg, tokens[:, S : S + 1], cache, S)
    np.testing.assert_allclose(dl[:, 0].numpy(), logits[:, S].numpy(), atol=2e-2, rtol=1e-3)
    dl2, _ = decode_step(params, cfg, tokens[:, S + 1 : S + 2], cache, S + 1)
    np.testing.assert_allclose(dl2[:, 0].numpy(), logits[:, S + 1].numpy(), atol=3e-2, rtol=1e-3)

    rt = jnp.asarray(tokens.numpy())
    _, rcache = R.prefill(rparams, rcfg, {"tokens": rt[:, :S]}, max_len=S + 4)
    _, cache = prefill(params, cfg, {"tokens": tokens[:, :S]}, max_len=S + 4)
    for pos in (S, S + 1):
        rdl, rcache = R.decode_step(rparams, rcfg, rt[:, pos : pos + 1], rcache, jnp.int32(pos))
        dl, cache = decode_step(params, cfg, tokens[:, pos : pos + 1], cache, pos)
        np.testing.assert_allclose(dl.numpy(), np.asarray(rdl), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cache["layers"]["b0"]["wkv"].numpy(),
                               np.asarray(rcache["layers"]["b0"]["wkv"]), atol=1e-4, rtol=1e-3)


def test_decode_updates_the_stacked_cache_in_place(ref_model):
    _, _, cfg, params = ref_model
    tokens = torch.from_numpy(_tokens(cfg, S + 1))
    _, cache = prefill(params, cfg, {"tokens": tokens[:, :S]}, max_len=S + 4)
    leaves = dict(leaves_with_names(cache["layers"]))
    before = {k: v.clone() for k, v in leaves.items()}
    _, after = decode_step(params, cfg, tokens[:, S : S + 1], cache, S)
    for name, leaf in leaves_with_names(after["layers"]):
        assert leaf is leaves[name], name
        assert not torch.equal(leaf, before[name]), name


def test_init_rwkv_cache_matches_reference():
    rcfg, cfg = ref_get_config(ARCH, "smoke"), get_config(ARCH, "smoke")
    want = ref_rwkv.init_rwkv_cache(rcfg, 3, jnp.bfloat16)
    got = rwkv.init_rwkv_cache(cfg, 3, torch.bfloat16, "cpu")
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert leaf_names(got) == [jax.tree_util.keystr(p) for p, _ in wl]
    for (_, w), (_, g) in zip(wl, leaves_with_names(got)):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()


def test_greedy_tokens_match_reference_engine(ref_model):
    rcfg, rparams, cfg, params = ref_model
    ref = RefEngine(rcfg, rparams, max_len=48)
    port = ServeEngine(cfg, params, max_len=48, device="cpu")
    for t in (8, 37):
        prompts = _tokens(cfg, t, seed=t)
        want = ref.generate(prompts, max_new_tokens=6)
        got = port.generate(prompts, max_new_tokens=6)
        assert got.shape == (B, 6) and got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# pad_cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 8])
def test_pad_cache_pads_only_sequence_leaves_as_the_reference(window):
    """State leaves (wkv, x_prev, cm/x_prev) keep their shapes; k and v are
    padded along dim 2 exactly as the reference pads them."""
    from repro_torch.models import pad_cache

    rng = np.random.default_rng(8)
    g, b, s, kv, d, h = 2, 2, 6, 4, 16, 4
    tree = {
        "attn": {"k": rng.standard_normal((g, b, s, kv, d)), "v": rng.standard_normal((g, b, s, kv, d))},
        "rwkv": {"wkv": rng.standard_normal((g, b, h, d, d)), "x_prev": rng.standard_normal((g, b, 64)),
                 "cm": {"x_prev": rng.standard_normal((g, b, 64))}},
    }
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    rcfg = ref_get_config("stablelm-3b", "smoke").copy(sliding_window=window)
    cfg = get_config("stablelm-3b", "smoke").copy(sliding_window=window)
    want = R.pad_cache({"layers": jax.tree.map(jnp.asarray, tree), "memory": None}, rcfg, 20)
    got = pad_cache({"layers": params_from_reference(tree), "memory": None}, cfg, 20)
    assert got["memory"] is None
    wl = jax.tree_util.tree_flatten_with_path(want["layers"])[0]
    assert leaf_names(got["layers"]) == [jax.tree_util.keystr(p) for p, _ in wl]
    for (_, w), (_, gt) in zip(wl, leaves_with_names(got["layers"])):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))
    rw = got["layers"]["rwkv"]
    assert rw["wkv"].shape == (g, b, h, d, d) and rw["x_prev"].shape == (g, b, 64)
    assert rw["cm"]["x_prev"].shape == (g, b, 64)
    assert got["layers"]["attn"]["k"].shape[2] == (8 if window else 20)
