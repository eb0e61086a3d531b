"""Flash attention: the port's plain twin against the reference's Pallas
kernel (interpret mode on the CPU) and its jnp oracle; the CUDA kernel
against the plain twin on a card (``-m cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as pallas_flash
from repro.kernels.ref import flash_attention_ref
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

# (B, S, H, KV, D, window, blocks): the reference's FLASH_CASES plus head_dim 80
FLASH_CASES = [
    (1, 128, 4, 4, 32, 0, 64),
    (2, 128, 4, 2, 32, 0, 64),
    (1, 256, 8, 2, 64, 0, 128),
    (2, 128, 4, 2, 32, 48, 32),
    (1, 64, 2, 1, 16, 0, 16),
    (1, 128, 4, 4, 80, 0, 128),
    (1, 256, 8, 2, 80, 0, 128),
]


def _qkv(b, s, h, kv, d, seed=0):
    r = np.random.default_rng(seed)
    return (
        r.standard_normal((b, s, h, d)).astype(np.float32),
        r.standard_normal((b, s, kv, d)).astype(np.float32),
        r.standard_normal((b, s, kv, d)).astype(np.float32),
    )


@pytest.mark.parametrize("b,s,h,kv,d,window,blk", FLASH_CASES)
def test_plain_twin_matches_pallas_kernel(b, s, h, kv, d, window, blk):
    q, k, v = _qkv(b, s, h, kv, d, seed=b * s + h)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                        window=window, block_q=blk, block_k=blk)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, window=window, block_k=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_plain_twin_bf16_matches_pallas_kernel():
    q, k, v = _qkv(2, 128, 4, 2, 32, seed=7)
    want = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), block_q=64, block_k=64)
    got = ops.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("s,h,kv,window,causal", [(72, 4, 2, 0, True), (200, 4, 4, 48, True), (300, 8, 2, 0, False)])
def test_plain_twin_ragged_s_matches_oracle(s, h, kv, window, causal):
    """Any S: the Pallas wrapper asserts S % block == 0; the port masks the
    ragged last block instead."""
    q, k, v = _qkv(2, s, h, kv, 32, seed=s)
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("s,q_chunk,window", [(16, 512, 0), (64, 16, 0), (64, 16, 24)])
def test_blockwise_attention_matches_reference(s, q_chunk, window):
    q, k, v = _qkv(2, s, 4, 2, 16, seed=s + window)
    want = ref_attn.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk, window=window)
    got = attn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   q_chunk, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_cpu_tensors_never_launch_the_kernel():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 2, 1, 16))
    before = fa.launches
    ops.flash_attention(q, k, v)
    assert fa.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q.reshape(2, 64, 16), k.reshape(1, 64, 16), v.reshape(1, 64, 16), group=2)


def _cuda_against_plain(b, s, h, kv, d, window, dtype, causal):
    """The kernel (one launch) against the plain twin on the CPU, on the same
    inputs in ``dtype``, at the bar of ``tests/test_kernels.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in _qkv(b, s, h, kv, d, seed=s))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), atol=tol, rtol=max(tol, 1e-4))


# The float32 cases run the scalar kernel; the bfloat16 cases the
# tensor-core kernel, at every padded head dim the serving configs use and
# at one (72) that is not a multiple of 16.
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", [
    (1, 128, 4, 4, 32, 0, torch.float32),
    (2, 128, 4, 2, 32, 48, torch.float32),
    (1, 300, 8, 2, 80, 0, torch.float32),
    (2, 300, 32, 32, 80, 0, torch.bfloat16),
    (1, 256, 32, 8, 128, 0, torch.bfloat16),
    (2, 128, 4, 2, 16, 0, torch.bfloat16),
    (2, 128, 4, 2, 32, 0, torch.bfloat16),
    (1, 256, 8, 2, 64, 0, torch.bfloat16),
    (1, 200, 8, 4, 72, 0, torch.bfloat16),
    (2, 128, 4, 2, 32, 48, torch.bfloat16),
    (1, 300, 16, 2, 128, 100, torch.bfloat16),
    (2, 200, 32, 32, 80, 0, torch.bfloat16),
    (1, 300, 64, 8, 128, 0, torch.bfloat16),
    (1, 77, 4, 1, 20, 0, torch.bfloat16),
])
def test_cuda_kernel_matches_plain_twin(b, s, h, kv, d, window, dtype):
    _cuda_against_plain(b, s, h, kv, d, window, dtype, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,dtype", [(200, 32, torch.float32), (300, 80, torch.bfloat16),
                                       (200, 128, torch.bfloat16)])
def test_cuda_kernel_bidirectional_ragged_matches_plain_twin(s, d, dtype):
    _cuda_against_plain(1, s, 8, 2, d, 0, dtype, causal=False)
