"""Cross-attention and the encoder's bidirectional attention against the
reference, module by module, float32 on the CPU: B1's plain twin with k/v
of a length of their own against the reference's
``gqa_scores_softmax_out(mask=None)`` (the f32 bar of
``tests/test_kernels.py``, atol 2e-5 / rtol 1e-4), forward and gradient;
the bidirectional twin against the Pallas kernel in interpret mode (equal
lengths); and ``cross_attn_fwd``, ``_bidir_attn``, ``_cross_cache`` and
``_xattn_decode`` on smoke weights of llama-3.2-vision and seamless
(``repro.models.init_params``, moved through numpy) with the tanh gate
set to 1.0 in both packages: at the reference's init (0) every
cross-attention adds exactly nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro.kernels.ops import flash_attention as pallas_flash
from repro.models import attention as ref_attn
from repro_torch.configs import get_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod

GATE = 1.0  # tanh(1.0) = 0.762


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


# (B, S_q, S_kv, H, KV, D, twin kv block): S_q below and above S_kv, ragged
# against every block, GQA groups 1, 2 and 4
CROSS_CASES = [
    (2, 12, 17, 4, 2, 16, 128),
    (1, 300, 77, 8, 2, 32, 64),
    (2, 40, 300, 4, 1, 64, 128),
    (1, 64, 161, 4, 4, 128, 32),
]


@pytest.mark.parametrize("b,sq,skv,h,kv,d,blk", CROSS_CASES)
def test_twin_with_own_kv_length_matches_reference(b, sq, skv, h, kv, d, blk):
    q, k, v = _rand(sq, b, sq, h, d), _rand(skv, b, skv, kv, d), _rand(d, b, skv, kv, d)
    want = ref_attn.gqa_scores_softmax_out(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=False, block_k=blk)
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_twin_gradient_with_own_kv_length_matches_jax_grad():
    """The backward ``repro_torch::flash_attention`` takes on the card
    (through the twin) against ``jax.grad`` of the reference's
    cross-attention core."""
    b, sq, skv, h, kv, d = 2, 24, 41, 4, 2, 16
    q, k, v, w = (_rand(1, b, sq, h, d), _rand(2, b, skv, kv, d), _rand(3, b, skv, kv, d),
                  _rand(4, b, sq, h, d))
    want = jax.grad(lambda q, k, v: jnp.sum(ref_attn.gqa_scores_softmax_out(q, k, v, None) * w),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (ops.flash_attention(*ts, causal=False, block_k=16) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,kv,d,blk", [(1, 128, 4, 4, 32, 64), (2, 256, 8, 2, 64, 128)])
def test_bidirectional_twin_matches_pallas_kernel(b, s, h, kv, d, blk):
    q, k, v = _rand(s, b, s, h, d), _rand(s + 1, b, s, kv, d), _rand(s + 2, b, s, kv, d)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                        block_q=blk, block_k=blk)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=False, block_k=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8)])
def test_unequal_lengths_refuse_mask_and_window(causal, window):
    q, k = torch.zeros(2, 12, 4, 16), torch.zeros(2, 17, 2, 16)
    with pytest.raises(ValueError, match="S_q=12 != S_kv=17"):
        ops.flash_attention(q, k, k, causal=causal, window=window)
    with pytest.raises(ValueError, match="S_q=12 != S_kv=17"):
        fa.flash_attention_plain(q[:, :, 0].reshape(2, 12, 16), k[:, :, 0], k[:, :, 0], group=1,
                                 causal=causal, window=window)


def _with_gate(tree, value):
    if isinstance(tree, dict):
        return {k: jnp.full_like(v, value) if k == "gate" else _with_gate(v, value)
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def blocks():
    """Per arch: (reference cfg, port cfg, reference params, port params),
    smoke, f32, every gate set to ``GATE``."""
    out = {}
    for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2"):
        rcfg = _f32(ref_get_config(arch, "smoke"))
        rparams = _with_gate(R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32),
                             GATE)
        out[arch] = (rcfg, _f32(get_config(arch, "smoke")), rparams,
                     params_from_reference(jax.tree.map(np.asarray, rparams)))
    return out


def _cross_params(arch, params):
    """The first cross-attention's params: llama's ``xattn`` mixer,
    seamless's decoder ``xattn`` sub-layer."""
    block = params["groups"]["b0"]
    sub = block["mixer"] if arch.startswith("llama") else block["xattn"]
    return jax.tree.map(lambda p: p[0], sub)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_cross_attn_fwd_cache_and_decode_match_reference(arch, blocks):
    rcfg, cfg, rparams, params = blocks[arch]
    rp, p = _cross_params(arch, rparams), _cross_params(arch, params)
    mem_d = rp["wk"].shape[0]
    assert float(rp["gate"][0]) == GATE and tuple(p["gate"].shape) == (1,)
    x, mem = _rand(1, 2, 9, cfg.d_model), _rand(2, 2, 23, mem_d)
    want = ref_attn.cross_attn_fwd(rp, jnp.asarray(x), jnp.asarray(mem), rcfg)
    got = attn.cross_attn_fwd(p, torch.from_numpy(x), torch.from_numpy(mem), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    # the gate scales the whole sub-layer: at the reference's init it adds nothing
    ungated = attn.cross_attn_fwd(dict(p, gate=torch.zeros(1)), torch.from_numpy(x),
                                  torch.from_numpy(mem), cfg)
    assert not ungated.any() and got.abs().max() > 1e-2
    rcache = R.model._cross_cache(rp, jnp.asarray(mem))
    cache = model_mod._cross_cache(p, torch.from_numpy(mem))
    for key in ("xk", "xv"):
        assert tuple(cache[key].shape) == (2, 23, cfg.num_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(rcache[key]), atol=2e-5,
                                   rtol=1e-4)
    # decode: one token against the cached memory equals the forward's row
    wd = R.model._xattn_decode(rp, jnp.asarray(x[:, 4:5]), rcache)
    d = model_mod._xattn_decode(p, torch.from_numpy(x[:, 4:5]), cache)
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(d[:, 0].numpy(), got[:, 4].numpy(), atol=2e-5, rtol=1e-4)


def test_bidir_attn_matches_reference(blocks):
    """seamless's encoder self-attention: RoPE, no mask."""
    rcfg, cfg, rparams, params = blocks["seamless-m4t-large-v2"]
    rp = jax.tree.map(lambda p: p[0], rparams["encoder"]["groups"]["b0"]["mixer"])
    p = jax.tree.map(lambda t: t[0], params["encoder"]["groups"]["b0"]["mixer"])
    h = _rand(5, 2, 21, cfg.d_model)
    want = R.model._bidir_attn(rp, jnp.asarray(h), rcfg, jnp.arange(21), False)
    got = model_mod._bidir_attn(p, torch.from_numpy(h), cfg, torch.arange(21))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    # bidirectional: the first position sees the last
    h2 = h.copy()
    h2[:, -1] += 1.0
    moved = model_mod._bidir_attn(p, torch.from_numpy(h2), cfg, torch.arange(21))
    assert (moved[:, 0] - got[:, 0]).abs().max() > 1e-4
