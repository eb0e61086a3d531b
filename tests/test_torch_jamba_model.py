"""Port parity for the jamba hybrid without experts (jamba-1.5-large
``smoke-no-moe`` config, float32): config, specs and init, the Mamba
pieces of ``models/ssm.py``, the model's forward, prefill and decode, and
greedy serving, against the reference on the same weights
(``repro.models.init_params``, moved through numpy). The reference inits
``conv_b`` to zeros and ``d_skip`` to ones, which would leave the conv
bias and the skip scale untested, so both sides get the same seeded
values instead."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import ssm as ref_ssm
from repro.models.sharding import ParamLeaf as RefLeaf
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.interop import leaf_names, params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import (
    BlockDef, count_params, decode_step, decoder_layout, forward, init_params, model_spec,
    pad_cache, prefill, spec_shapes,
)
from repro_torch.models import layers, ssm
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import leaves_with_names

ARCH = "jamba-1.5-large-398b"
B, S = 2, 16
ATOL, RTOL = 5e-3, 1e-3  # model-level bar of tests/test_kernels.py
MAMBA_BLOCKS = ("b0", "b1", "b2", "b3", "b5", "b6", "b7")  # b4 is attention


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


def _ref_cfg(variant):
    """The reference's config for a port variant: ``no-moe`` and
    ``smoke-no-moe`` are ``full()`` cut to 16 layers and ``smoke()``, each
    with ``MoEConfig()``."""
    if variant == "no-moe":
        return ref_get_config(ARCH, "full").copy(num_layers=16, moe=RefMoEConfig())
    return ref_get_config(ARCH, "smoke").copy(moe=RefMoEConfig())


def _build(num_layers):
    rcfg = _f32(_ref_cfg("smoke-no-moe")).copy(num_layers=num_layers)
    np_tree = jax.tree.map(np.asarray, R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32))
    rng = np.random.default_rng(42)
    for name in MAMBA_BLOCKS:
        mixer = np_tree["groups"][name]["mixer"]
        mixer["conv_b"] = (rng.standard_normal(mixer["conv_b"].shape) * 0.5).astype(np.float32)
        mixer["d_skip"] = rng.uniform(0.5, 1.5, mixer["d_skip"].shape).astype(np.float32)
    cfg = _f32(get_config(ARCH, "smoke-no-moe")).copy(num_layers=num_layers)
    return rcfg, jax.tree.map(jnp.asarray, np_tree), cfg, params_from_reference(np_tree, "cpu")


@pytest.fixture(scope="module")
def ref_model():
    """(reference cfg, reference params, port cfg, port params): one group."""
    return _build(8)


@pytest.fixture(scope="module")
def ref_model_2groups():
    """The same at 16 smoke layers: two stacked groups."""
    return _build(16)


def _tokens(cfg, t, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, t)).astype(np.int32)


def _mixer0(params, block="b0"):
    """Layer 0's Mamba parameters of one block."""
    return jax.tree.map(lambda p: p[0], params["groups"][block]["mixer"])


# ---------------------------------------------------------------------------
# Configs, specs, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["smoke", "full", "smoke-no-moe", "no-moe"])
def test_configs_equal_reference(variant):
    want = ref_get_config(ARCH, variant) if variant in ("smoke", "full") else _ref_cfg(variant)
    assert dataclasses.asdict(get_config(ARCH, variant)) == dataclasses.asdict(want)


@pytest.mark.parametrize("variant", ["smoke-no-moe", "no-moe"])
def test_spec_count_and_leaf_names_equal_reference(variant):
    """Specs only: nothing is allocated at full size."""
    rspec, spec = R.model_spec(_ref_cfg(variant)), model_spec(get_config(ARCH, variant))
    is_leaf = lambda x: isinstance(x, RefLeaf)  # noqa: E731
    assert spec_shapes(spec) == jax.tree.map(lambda leaf: leaf.shape, rspec, is_leaf=is_leaf)
    assert count_params(spec) == R.count_params(rspec)
    paths = jax.tree_util.tree_flatten_with_path(rspec, is_leaf=is_leaf)[0]
    assert leaf_names(spec) == [jax.tree_util.keystr(p) for p, _ in paths]
    if variant == "no-moe":
        assert count_params(spec) == 16_924_327_360


def test_layout_is_the_references():
    cfg = get_config(ARCH, "no-moe")
    layout = decoder_layout(cfg)
    assert layout.num_groups == 2 and layout.num_layers == 16
    assert [b.mixer for b in layout.group] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert all(b.mlp == "dense" for b in layout.group)
    ref = R.model.decoder_layout(_ref_cfg("no-moe"))
    assert [(b.mixer, b.mlp) for b in ref.group] == [(b.mixer, b.mlp) for b in layout.group]
    assert not cfg.use_rope


@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_published_config_with_experts_raises(variant):
    """The published configs lay out with experts on blocks 1, 3, 5 and 7
    as the reference's do (they raised before MoE was ported); a variant
    the arch does not have raises, naming the ones it has."""
    layout = decoder_layout(get_config(ARCH, variant))
    ref = R.model.decoder_layout(ref_get_config(ARCH, variant))
    assert [(b.mixer, b.mlp) for b in layout.group] == [(b.mixer, b.mlp) for b in ref.group]
    assert [b.mlp for b in layout.group] == ["dense", "moe"] * 4
    with pytest.raises(KeyError, match="smoke-no-moe"):
        get_config(ARCH, "moe")


def test_mamba_custom_inits_follow_the_reference():
    """a_log = log(1..N) tiled over channels and layers; dt_b inverts a
    softplus of dt in [1e-3, 1e-1], drawn anew for every layer; conv_b
    zeros, d_skip ones."""
    rcfg, cfg = _f32(_ref_cfg("smoke-no-moe")), _f32(get_config(ARCH, "smoke-no-moe"))
    want = R.init_params(jax.random.key(1), R.model_spec(rcfg), jnp.float32)["groups"]["b0"]["mixer"]
    got = init_params(model_spec(cfg), torch.Generator().manual_seed(1), torch.float32,
                      "cpu")["groups"]["b0"]["mixer"]
    np.testing.assert_allclose(got["a_log"].numpy(), np.asarray(want["a_log"]), atol=1e-7)
    dt = layers.softplus(got["dt_b"])
    assert got["dt_b"].shape == (1, 2 * cfg.d_model)
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
    two = init_params(model_spec(cfg.copy(num_layers=16)), torch.Generator().manual_seed(1),
                      torch.float32, "cpu")["groups"]["b0"]["mixer"]["dt_b"]
    assert not torch.equal(two[0], two[1])  # a fresh draw per layer
    assert not got["conv_b"].any() and torch.equal(got["d_skip"], torch.ones_like(got["d_skip"]))


def test_softplus_matches_jax_above_twenty():
    x = np.array([-30.0, -5.0, 0.0, 3.0, 19.5, 20.5, 25.0, 80.0], np.float32)
    np.testing.assert_array_equal(layers.softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# The Mamba pieces
# ---------------------------------------------------------------------------


def _hidden(width, t=12, seed=4):
    return np.random.default_rng(seed).standard_normal((B, t, width)).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_causal_matches_reference(with_state, ref_model):
    _, rparams, _, params = ref_model
    rp, p = _mixer0(rparams), _mixer0(params)
    di = p["conv_w"].shape[1]
    x = _hidden(di)
    state = _hidden(di, t=3, seed=5) if with_state else None
    want, want_s = ref_ssm._conv1d_causal(jnp.asarray(x), rp["conv_w"], rp["conv_b"],
                                          None if state is None else jnp.asarray(state))
    got, got_s = ssm._conv1d_causal(torch.from_numpy(x), p["conv_w"], p["conv_b"],
                                    None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=1e-5)


def test_ssm_inputs_match_reference(ref_model):
    rcfg, rparams, cfg, params = ref_model
    x = _hidden(2 * cfg.d_model)
    want = ref_ssm._ssm_inputs(_mixer0(rparams), jnp.asarray(x), rcfg)
    got = ssm._ssm_inputs(_mixer0(params), torch.from_numpy(x), cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("t", [12, 67])  # chunk 12, and a prime T above 64: chunk 1
def test_mamba_fwd_matches_reference(use_pallas, t, ref_model):
    rcfg, rparams, cfg, params = ref_model
    x = _hidden(cfg.d_model, t=t)
    want_y, want_c = ref_ssm.mamba_fwd(_mixer0(rparams), jnp.asarray(x),
                                       rcfg.copy(use_pallas=use_pallas), return_cache=True)
    got_y, got_c = ssm.mamba_fwd(_mixer0(params), torch.from_numpy(x),
                                 cfg.copy(use_pallas=use_pallas), return_cache=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    assert set(got_c) == set(want_c) == {"h", "conv"}
    for k in got_c:
        np.testing.assert_allclose(got_c[k].numpy(), np.asarray(want_c[k]), atol=1e-5, rtol=1e-5)


def test_chunk_scan_xla_path_matches_reference():
    """The reference's XLA path against the scan the port's ``mamba_fwd``
    runs on the CPU (the kernel's plain twin), from a nonzero state."""
    rng = np.random.default_rng(6)
    b, t, di, n, chunk = 2, 24, 16, 4, 8
    dt = np.logaddexp(rng.standard_normal((b, t, di)), 0.0).astype(np.float32)
    bm, cm, x = (rng.standard_normal(s).astype(np.float32) for s in ((b, t, n), (b, t, n), (b, t, di)))
    a = -np.exp(rng.standard_normal((di, n)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    arrays = (dt, bm, cm, a, x, h0)
    want_y, want_h = ref_ssm._chunk_scan(*(jnp.asarray(v) for v in arrays), chunk)
    got_y, got_h = ops.mamba_chunk_scan(*(torch.from_numpy(v) for v in arrays), chunk=chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t,chunk", [(300, 60), (200, 50), (293, 1), (67, 1), (37, 37), (2048, 64)])
def test_chunk_rule_is_the_references(t, chunk):
    assert ssm.scan_chunk(t) == chunk


def test_mamba_decode_matches_reference_and_updates_in_place(ref_model):
    rcfg, rparams, cfg, params = ref_model
    rng = np.random.default_rng(7)
    di, n = 2 * cfg.d_model, cfg.mamba.state_dim
    x = _hidden(cfg.d_model, t=1)
    cache = {"h": rng.standard_normal((B, di, n)).astype(np.float32),
             "conv": rng.standard_normal((B, cfg.mamba.conv_width - 1, di)).astype(np.float32)}
    want_y, want_c = ref_ssm.mamba_decode(_mixer0(rparams), jnp.asarray(x),
                                          jax.tree.map(jnp.asarray, cache), rcfg)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got_y, got_c = ssm.mamba_decode(_mixer0(params), torch.from_numpy(x), tcache, cfg)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    for k in ("h", "conv"):
        assert got_c[k] is tcache[k]
        np.testing.assert_allclose(got_c[k].numpy(), np.asarray(want_c[k]), atol=1e-5, rtol=1e-5)
    init = ssm.init_mamba_cache(cfg, 3, torch.bfloat16, "cpu")
    want_init = ref_ssm.init_mamba_cache(rcfg, 3, jnp.bfloat16)
    for k in ("h", "conv"):
        assert tuple(init[k].shape) == want_init[k].shape and not init[k].any()
        assert str(init[k].dtype).split(".")[-1] == str(want_init[k].dtype)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("t", [S + 2, 37, 67])  # 67 is a prime above 64: the scan runs chunk 1
def test_forward_logits_match_reference(use_pallas, t, ref_model):
    rcfg, rparams, cfg, params = ref_model
    tokens = _tokens(cfg, t)
    want, _ = R.forward(rparams, rcfg.copy(use_pallas=use_pallas), {"tokens": jnp.asarray(tokens)})
    got, aux = forward(params, cfg.copy(use_pallas=use_pallas), {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, t, cfg.vocab_size) and set(aux) == {"lb_loss", "z_loss"}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_match_reference_at_two_groups(use_pallas, ref_model_2groups):
    rcfg, rparams, cfg, params = ref_model_2groups
    assert decoder_layout(cfg).num_groups == 2
    tokens = _tokens(cfg, S)
    want, _ = R.forward(rparams, rcfg.copy(use_pallas=use_pallas), {"tokens": jnp.asarray(tokens)})
    got, _ = forward(params, cfg.copy(use_pallas=use_pallas), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_forward_cache_matches_reference(ref_model_2groups):
    rcfg, rparams, cfg, params = ref_model_2groups
    tokens = _tokens(cfg, S)
    _, _, want = R.forward(rparams, rcfg, {"tokens": jnp.asarray(tokens)}, return_cache=True)
    _, _, got = forward(params, cfg, {"tokens": torch.from_numpy(tokens)}, return_cache=True)
    want_leaves = jax.tree_util.tree_flatten_with_path(want["layers"])[0]
    assert leaf_names(got["layers"]) == [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (_, w), (_, g) in zip(want_leaves, leaves_with_names(got["layers"])):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("fixture", ["ref_model", "ref_model_2groups"])
def test_prefill_decode_matches_forward(fixture, request):
    """tests/test_decode_consistency.py's contract, on the port, plus the
    decode logits and state against the reference's decode."""
    rcfg, rparams, cfg, params = request.getfixturevalue(fixture)
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
    for name in ("h", "conv"):
        np.testing.assert_allclose(cache["layers"]["b0"][name].numpy(),
                                   np.asarray(rcache["layers"]["b0"][name]), atol=1e-4, rtol=1e-3)


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


def test_pad_cache_leaves_mamba_state_and_pads_attention_as_the_reference(ref_model_2groups):
    rcfg, rparams, cfg, params = ref_model_2groups
    tokens = _tokens(cfg, S)
    _, _, want = R.forward(rparams, rcfg, {"tokens": jnp.asarray(tokens)}, return_cache=True)
    _, _, got = forward(params, cfg, {"tokens": torch.from_numpy(tokens)}, return_cache=True)
    want = R.pad_cache(want, rcfg, 40)
    got = pad_cache(got, cfg, 40)
    wl = jax.tree_util.tree_flatten_with_path(want["layers"])[0]
    assert leaf_names(got["layers"]) == [jax.tree_util.keystr(p) for p, _ in wl]
    for (_, w), (_, g) in zip(wl, leaves_with_names(got["layers"])):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3)
    di, n = 2 * cfg.d_model, cfg.mamba.state_dim
    assert got["layers"]["b0"]["h"].shape == (2, B, di, n)
    assert got["layers"]["b0"]["conv"].shape == (2, B, cfg.mamba.conv_width - 1, di)
    k = got["layers"]["b4"]["k"]
    assert k.shape == (2, B, 40, cfg.num_kv_heads, cfg.head_dim) and not k[:, :, S:].any()


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bdef,name", [(BlockDef("retnet", "dense"), "retnet"),
                                       (BlockDef("hyena", "dense"), "hyena")])
def test_unknown_block_kinds_raise_in_forward_and_decode(bdef, name, ref_model):
    """A mixer that no layout has raises instead of running another block's
    code."""
    _, _, cfg, params = ref_model
    bp = jax.tree.map(lambda p: p[0], params["groups"]["b0"])
    x = torch.from_numpy(_hidden(cfg.d_model, t=4))
    with pytest.raises(ValueError, match=name):
        model_mod._block_fwd(bdef, bp, x, cfg, torch.arange(4), False)
    cache = ssm.init_mamba_cache(cfg, B, torch.float32, "cpu")
    with pytest.raises(ValueError, match=name):
        model_mod._block_decode(bdef, bp, x[:, :1], cache, 4, cfg)


def test_serve_cli_runs_the_smoke_variant_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_cli

    serve_cli.main(["--arch", ARCH, "--variant", "smoke-no-moe", "--device", "cpu",
                    "--requests", "3", "--batch-size", "2", "--max-prompt-len", "20",
                    "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "3 requests in 2 batches, 9 tokens" in out and "on cpu" in out
