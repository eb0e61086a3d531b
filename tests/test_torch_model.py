"""Port parity at model level for the dense branch (stablelm, granite,
starcoder2 with its QKV biases and tanh GELU, qwen2.5 with head dim 16 and
one kv head at smoke size): specs, weight interop, forward logits and the
prefill+decode == forward serving contract, against the reference on the
same weights (built by ``repro.models.init_params``, moved through
numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import SyntheticTokens
from repro.models.sharding import ParamLeaf as RefLeaf
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.interop import leaf_names, params_from_reference, params_to_reference
from repro_torch.models import (
    count_params, decode_step, forward, init_params, model_spec, prefill, spec_shapes,
)

ARCHS = ["stablelm-3b", "granite-3-8b", "starcoder2-15b", "qwen2.5-14b"]
B, S = 2, 16


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def ref_models():
    """Reference params and the port's copy of them, built once per arch."""
    out = {}
    for arch in ARCHS:
        rcfg = _f32(ref_get_config(arch, "smoke"))
        rparams = R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32)
        np_tree = jax.tree.map(np.asarray, rparams)
        out[arch] = (rcfg, rparams, np_tree, _f32(get_config(arch, "smoke")),
                     params_from_reference(np_tree, "cpu"))
    return out


def _tokens(cfg, seed=3):
    src = SyntheticTokens(cfg, B, S + 2, seed=seed)
    return src.batch_at(0)["tokens"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_spec_shapes_equal_reference(arch, variant):
    rspec = R.model_spec(ref_get_config(arch, variant))
    want = jax.tree.map(lambda leaf: leaf.shape, rspec, is_leaf=lambda x: isinstance(x, RefLeaf))
    spec = model_spec(get_config(arch, variant))
    assert spec_shapes(spec) == want
    assert count_params(spec) == R.count_params(rspec)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_roundtrip_and_leaf_order(arch, ref_models):
    _, rparams, np_tree, _, params = ref_models[arch]
    paths = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert leaf_names(params) == [jax.tree_util.keystr(p) for p, _ in paths]
    back = params_to_reference(params)
    for (_, want), got in zip(paths, jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, np.asarray(want))
    bf16 = params_from_reference(np_tree, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(bf16))


def test_init_params_follow_reference_rules():
    cfg = get_config("stablelm-3b", "smoke")
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    g = params["groups"]["b0"]
    assert torch.equal(g["norm1"]["scale"], torch.ones(2, 64))
    assert torch.equal(g["norm1"]["bias"], torch.zeros(2, 64))
    assert abs(params["embed"].std().item() - 0.02) < 2e-3
    # fan-in counts every dim but the last, the stacked layer axis included
    fan_in = cfg.num_layers * cfg.d_model * cfg.num_heads
    assert abs(g["mixer"]["wq"].std().item() * fan_in**0.5 - 1.0) < 0.05
    again = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert torch.equal(again["groups"]["b0"]["mlp"]["w_in"], g["mlp"]["w_in"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_match_reference(arch, use_pallas, ref_models):
    rcfg, rparams, _, cfg, params = ref_models[arch]
    tokens = _tokens(cfg)
    want, _ = R.forward(rparams, rcfg.copy(use_pallas=use_pallas), {"tokens": jnp.asarray(tokens)})
    got, aux = forward(params, cfg.copy(use_pallas=use_pallas), {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and set(aux) == {"lb_loss", "z_loss"}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, ref_models):
    """tests/test_decode_consistency.py's contract, on the port, plus the
    decode logits against the reference's decode."""
    rcfg, rparams, _, cfg, params = ref_models[arch]
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


def test_sliding_window_ring_buffer_matches_reference(ref_models):
    """Decoding past a sliding window through the ring cache stays equal to
    the full forward, on a dense config given a window of 8."""
    rcfg, rparams, _, cfg, params = ref_models["stablelm-3b"]
    rcfg, cfg = rcfg.copy(sliding_window=8), cfg.copy(sliding_window=8)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 24)).astype(np.int32)
    want, _ = R.forward(rparams, rcfg, {"tokens": jnp.asarray(tokens)})
    t = torch.from_numpy(tokens)
    logits, _ = forward(params, cfg, {"tokens": t})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=5e-3, rtol=1e-3)
    _, cache = prefill(params, cfg, {"tokens": t[:, :12]}, max_len=24)  # S > window: ring roll
    assert cache["layers"]["b0"]["k"].shape[2] == 8
    for pos in range(12, 24):
        dl, cache = decode_step(params, cfg, t[:, pos : pos + 1], cache, pos)
        np.testing.assert_allclose(dl[:, 0].numpy(), logits[:, pos].numpy(), atol=3e-2, rtol=1e-3,
                                   err_msg=f"divergence at pos {pos}")


def test_unported_arch_and_missing_card_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-j-6b")  # in neither package
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
