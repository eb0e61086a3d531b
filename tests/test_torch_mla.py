"""MLA and B1 at MLA's head dims, against the reference, float32.

``models/mla.py``: ``mla_fwd`` (with its cache) and the absorbed
``mla_decode`` against the reference's at atol 1e-5 on one smoke MLA
layer of deepseek-v3 (head dim qk_nope + qk_rope = 24, V padded from 16).
B1's plain twin at D = 192 (full width: 128 + 64) and D = 24 against the
Pallas kernel in interpret mode and the oracle in ``kernels/ref.py``; on
a card (``-m cuda``) the kernel against the twin at D = 192 and 24."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.ops import flash_attention as pallas_flash
from repro.kernels.ref import flash_attention_ref
from repro.models import mla as ref_mla
from repro.models.sharding import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import mla

B, S = 2, 12


@pytest.fixture(scope="module")
def layer():
    """(reference cfg, reference params, port cfg, port params) of one
    smoke MLA layer, float32."""
    rcfg = ref_get_config("deepseek-v3-671b", "smoke").copy(param_dtype="float32",
                                                            compute_dtype="float32")
    rparams = ref_init_params(jax.random.key(2), ref_mla.mla_spec(rcfg), jnp.float32)
    cfg = get_config("deepseek-v3-671b", "smoke").copy(param_dtype="float32",
                                                       compute_dtype="float32")
    return rcfg, rparams, cfg, params_from_reference(jax.tree.map(np.asarray, rparams))


def _x(cfg, s, seed=0):
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("q_chunk,use_pallas", [(512, False), (4, False), (4, True)])
def test_mla_fwd_and_cache_match_reference(q_chunk, use_pallas, layer):
    """The CPU path is the chunked attention whatever ``use_pallas`` says,
    as the reference's MLA ignores it; q_chunk 4 takes the chunked branch."""
    rcfg, rparams, cfg, params = layer
    x = _x(cfg, S)
    want, wcache = ref_mla.mla_fwd(rparams, jnp.asarray(x), rcfg.copy(q_chunk=q_chunk),
                                   jnp.arange(S), return_cache=True)
    before = fa.launches
    got, cache = mla.mla_fwd(params, torch.from_numpy(x),
                             cfg.copy(q_chunk=q_chunk, use_pallas=use_pallas), torch.arange(S),
                             return_cache=True)
    assert fa.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert sorted(cache) == ["c_kv", "k_rope"]
    for key in cache:
        assert cache[key].shape == wcache[key].shape
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(wcache[key]), atol=1e-5,
                                   rtol=1e-5, err_msg=key)


def test_mla_decode_matches_reference_and_forward(layer):
    """Absorbed decode from a cache of ``init_mla_cache`` filled by the
    forward's, two steps: each equals the reference's decode (output and
    cache) and the expanded forward at that position."""
    rcfg, rparams, cfg, params = layer
    x = _x(cfg, S + 2, seed=1)
    full = mla.mla_fwd(params, torch.from_numpy(x), cfg, torch.arange(S + 2))
    _, pre = mla.mla_fwd(params, torch.from_numpy(x[:, :S]), cfg, torch.arange(S),
                         return_cache=True)
    cache = mla.init_mla_cache(cfg, B, S + 4, torch.float32)
    rcache = ref_mla.init_mla_cache(rcfg, B, S + 4, jnp.float32)
    for key in cache:
        assert cache[key].shape == rcache[key].shape and not cache[key].any()
        cache[key][:, :S] = pre[key]
        rcache[key] = rcache[key].at[:, :S].set(jnp.asarray(pre[key].numpy()))
    for pos in (S, S + 1):
        want, rcache = ref_mla.mla_decode(rparams, jnp.asarray(x[:, pos : pos + 1]), rcache,
                                          jnp.int32(pos), rcfg)
        got, cache = mla.mla_decode(params, torch.from_numpy(x[:, pos : pos + 1]), cache, pos,
                                    cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, pos].numpy(), atol=1e-5,
                                   rtol=1e-5)
        for key in cache:
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(rcache[key]), atol=1e-5,
                                       rtol=1e-5, err_msg=key)


def _qkv(b, s, h, d, seed, dv=None):
    """q, k and v of MHA; with ``dv``, v's last d - dv columns are zero,
    as MLA pads V."""
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    if dv is not None:
        v[..., dv:] = 0.0
    return q, k, v


# (B, S, H, D, block, V's own width): MLA's full-width head dim and the
# smoke config's (24, not a multiple of 8 or 16)
MLA_CASES = [(1, 128, 2, 192, 64, 128), (2, 128, 4, 24, 32, 16), (1, 64, 3, 192, 64, None)]


@pytest.mark.parametrize("b,s,h,d,blk,dv", MLA_CASES)
def test_plain_twin_at_mla_head_dims_matches_pallas_kernel(b, s, h, d, blk, dv):
    q, k, v = _qkv(b, s, h, d, seed=d + s, dv=dv)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                        block_q=blk, block_k=blk)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, block_k=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    if dv is not None:  # padded V gives zero columns
        assert not got[..., dv:].any()


@pytest.mark.parametrize("s,d", [(77, 192), (45, 24)])
def test_plain_twin_at_mla_head_dims_ragged_matches_oracle(s, d):
    q, k, v = _qkv(2, s, 4, d, seed=s)
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_kernel_takes_head_dim_192_and_refuses_more():
    """The wrapper's bound is MLA's head dim; past it, it raises (the shape
    is checked before the device)."""
    assert fa.MAX_HEAD_DIM == 192
    q = torch.zeros(2, 16, 193)
    with pytest.raises(ValueError, match="D=193"):
        fa.flash_attention_cuda(q, q, q, group=1)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q[..., :192], q[..., :192], q[..., :192], group=1)


# MLA's serving shape (B=4, S=300, H=128 at D=192 in bf16) is chip_smoke.py's
# case; these hold the D = 192 and D = 24 kernels at test sizes.
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,dtype", [
    (2, 300, 8, 192, torch.bfloat16),
    (1, 77, 4, 192, torch.bfloat16),
    (1, 200, 4, 192, torch.float32),
    (2, 72, 4, 24, torch.float32),
    (2, 72, 4, 24, torch.bfloat16),
])
def test_cuda_kernel_at_mla_head_dims_matches_plain_twin(b, s, h, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _qkv(b, s, h, d, seed=s, dv=d * 2 // 3))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), atol=tol,
                               rtol=max(tol, 1e-4))
