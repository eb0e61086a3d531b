"""RWKV-6 WKV: the port's plain twin against the reference's Pallas kernel
(interpret mode on the CPU) and its token-by-token oracle; the CUDA kernel
against the plain twin on a card (``-m cuda``). Inputs come from numpy
seeds; tolerances are those of ``tests/test_kernels.py`` (atol 1e-4,
rtol 1e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import rwkv6_chunked as pallas_rwkv6
from repro.kernels.ref import rwkv6_ref
from repro.kernels.rwkv6 import rwkv6_chunked_bh as pallas_rwkv6_bh
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as wkv
from repro_torch.models.rwkv import wkv_chunk

ATOL, RTOL = 1e-4, 1e-3

# (B, T, H, K, chunk, nonzero s0, constant logw or None, label)
CASES = [
    (1, 32, 2, 8, 16, False, None, "reference case 1"),
    (2, 64, 3, 16, 16, False, None, "reference case 2"),
    (2, 96, 2, 16, 32, False, None, "reference case 3"),
    (1, 32, 2, 8, 8, True, None, "nonzero s0"),
    (1, 64, 1, 8, 32, False, -30.0, "logw = -30"),
    (2, 30, 2, 8, 30, True, None, "chunk 30"),
    (1, 25, 2, 16, 25, False, None, "chunk 25"),
    (2, 37, 2, 8, 1, True, None, "chunk 1, prime T"),
]


def _inputs(b, t, h, k, seed, nonzero_s0=False, logw=None):
    """(r, k, v, logw, u, s0) as float32 numpy arrays, model layout. r is
    scaled by K^-0.5, as a query is, so outputs stay O(1) at K = 64 and
    the absolute tolerance measures rounding, not the outputs' size."""
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, t, h, k)).astype(np.float32) for _ in range(3))
    r *= np.float32(k**-0.5)
    if logw is None:
        lw = -np.exp(rng.standard_normal((b, t, h, k))).astype(np.float32)
    else:
        lw = np.full((b, t, h, k), logw, np.float32)
    u = (rng.standard_normal((h, k)) * 0.2).astype(np.float32)
    s0 = rng.standard_normal((b, h, k, k)) if nonzero_s0 else np.zeros((b, h, k, k))
    return r, kk, v, lw, u, s0.astype(np.float32)


def _close_both_ways(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(want, got, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,t,h,k,chunk,nonzero_s0,logw,label", CASES, ids=[c[-1] for c in CASES])
def test_plain_twin_matches_pallas_kernel_and_oracle(b, t, h, k, chunk, nonzero_s0, logw, label):
    arrays = _inputs(b, t, h, k, seed=t * 7 + h, nonzero_s0=nonzero_s0, logw=logw)
    want_o, want_s = pallas_rwkv6(*(jnp.asarray(a) for a in arrays), chunk=chunk)
    got_o, got_s = ops.rwkv6_chunked(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    assert got_o.shape == (b, t, h, k) and got_s.shape == (b, h, k, k)
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    _close_both_ways(got_o.numpy(), np.asarray(want_o))
    _close_both_ways(got_s.numpy(), np.asarray(want_s))
    ref_o, ref_s = rwkv6_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=ATOL, rtol=RTOL)


def test_plain_twin_takes_a_bonus_per_row_like_the_pallas_kernel():
    """On the (B·H, T, K) layout each row has its own ``u``, as the Pallas
    kernel's (B·H, 1, K) input does."""
    rng = np.random.default_rng(11)
    bh, t, k = 3, 48, 16
    r, kk, v = (rng.standard_normal((bh, t, k)).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.standard_normal((bh, t, k))).astype(np.float32)
    u = rng.standard_normal((bh, 1, k)).astype(np.float32)
    s0 = rng.standard_normal((bh, k, k)).astype(np.float32)
    arrays = (r, kk, v, lw, u, s0)
    want_o, want_s = pallas_rwkv6_bh(*(jnp.asarray(a) for a in arrays), chunk=16, interpret=True)
    got_o, got_s = wkv.rwkv6_plain(*(torch.from_numpy(a) for a in arrays), chunk=16)
    _close_both_ways(got_o.numpy(), np.asarray(want_o))
    _close_both_ways(got_s.numpy(), np.asarray(want_s))


def test_plain_twin_rejects_a_chunk_that_does_not_divide_t():
    arrays = [torch.from_numpy(a) for a in _inputs(1, 30, 1, 8, seed=0)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.rwkv6_chunked(*arrays, chunk=16)


def test_cpu_tensors_never_launch_the_kernel():
    r, k, v, lw, u, s0 = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 8, seed=1))
    before = wkv.launches
    ops.rwkv6_chunked(r, k, v, lw, u, s0, chunk=8)
    assert wkv.launches == before
    flat = [x.reshape(2, 16, 8) for x in (r, k, v, lw)]
    with pytest.raises(ValueError, match="CUDA"):
        wkv.rwkv6_cuda(*flat, u.reshape(2, 1, 8), s0.reshape(2, 8, 8))


@pytest.mark.parametrize("k,nonzero_s0,logw", [(16, True, None), (8, False, -30.0)])
def test_plain_twin_does_not_depend_on_the_chunk(k, nonzero_s0, logw):
    """The property the CUDA kernel relies on when it tiles time with a
    chunk of its own: at T = 96 the plain twin gives the same out and final
    state at chunks 1, 3 and 32, and each matches the Pallas kernel
    (interpret mode) at that chunk."""
    arrays = _inputs(2, 96, 2, k, seed=96 + k, nonzero_s0=nonzero_s0, logw=logw)
    flat = [a.transpose(0, 2, 1, 3).reshape(4, 96, -1) for a in arrays[:4]]
    u = np.broadcast_to(arrays[4][None], (2, 2, k)).reshape(4, 1, k).copy()
    bh_arrays = (*flat, u, arrays[5].reshape(4, k, k))
    results = {}
    for chunk in (1, 3, 32):
        got_o, got_s = wkv.rwkv6_plain(*(torch.from_numpy(a) for a in bh_arrays), chunk=chunk)
        want_o, want_s = pallas_rwkv6_bh(*(jnp.asarray(a) for a in bh_arrays), chunk=chunk,
                                         interpret=True)
        _close_both_ways(got_o.numpy(), np.asarray(want_o))
        _close_both_ways(got_s.numpy(), np.asarray(want_s))
        results[chunk] = (got_o.numpy(), got_s.numpy())
    for chunk in (3, 32):
        _close_both_ways(results[chunk][0], results[1][0])
        _close_both_ways(results[chunk][1], results[1][1])


# (B, T, H, K, chunk, nonzero s0, constant logw)
CUDA_CASES = [
    (1, 32, 2, 8, 16, False, None),
    (2, 96, 2, 16, 32, False, None),
    (1, 32, 2, 8, 8, True, None),
    (1, 64, 1, 8, 32, False, -30.0),
    (2, 37, 2, 16, 1, True, None),
    (1, 300, 64, 64, 30, True, None),  # rwkv6-7b's heads at a serving length
    (1, 293, 64, 64, 1, True, None),  # a prime prompt: chunk 1
    (1, 293, 4, 64, 1, False, -30.0),
    (2, 45, 2, 6, 5, True, None),  # K = V = 6: 4-byte copies
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,k,chunk,nonzero_s0,logw", CUDA_CASES)
def test_cuda_kernel_matches_plain_twin(b, t, h, k, chunk, nonzero_s0, logw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = _inputs(b, t, h, k, seed=t + h, nonzero_s0=nonzero_s0, logw=logw)
    before = wkv.launches
    got_o, got_s = ops.rwkv6_chunked(*(torch.from_numpy(a).cuda() for a in arrays), chunk=chunk)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    want_o, want_s = ops.rwkv6_chunked(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    np.testing.assert_allclose(got_o.cpu().numpy(), want_o.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_s.cpu().numpy(), want_s.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [293, 300])
def test_cuda_result_does_not_depend_on_the_chunk(t):
    """On the card ``ops.rwkv6_chunked`` gives the same result for chunk 1
    and chunk 32 (the kernel tiles time by its own chunk), and matches the
    plain twin at the chunk the reference's rule picks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = _inputs(2, t, 8, 64, seed=t, nonzero_s0=True)
    on_card = [torch.from_numpy(a).cuda() for a in arrays]
    got = {chunk: ops.rwkv6_chunked(*on_card, chunk=chunk) for chunk in (1, 32)}
    torch.cuda.synchronize()
    for x, y in zip(got[1], got[32]):
        assert torch.equal(x, y)
    chunk = wkv_chunk(t)  # the reference's rule: 1 at T = 293, 30 at T = 300
    want_o, want_s = ops.rwkv6_chunked(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    np.testing.assert_allclose(got[1][0].cpu().numpy(), want_o.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[1][1].cpu().numpy(), want_s.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, k, v, lw, u, s0 = (torch.from_numpy(a).cuda() for a in _inputs(1, 64, 1, 8, seed=2))
    flat = [x.reshape(1, 64, 8) for x in (r, k, v, lw)]
    u, s0 = u.reshape(1, 1, 8), s0.reshape(1, 8, 8)
    with pytest.raises(TypeError, match="float32"):
        wkv.rwkv6_cuda(*(x.bfloat16() for x in flat), u, s0)
    with pytest.raises(TypeError, match="chunk"):
        wkv.rwkv6_cuda(*flat, u, s0, chunk=32)  # the kernel picks its own chunk
    empty = [x[:, :0] for x in flat]  # T = 0
    with pytest.raises(ValueError, match="unsupported"):
        wkv.rwkv6_cuda(*empty, u, s0)
    wide = [x.repeat(1, 1, 16) for x in flat]  # K = V = 128
    with pytest.raises(ValueError, match="unsupported"):
        wkv.rwkv6_cuda(*wide, u.repeat(1, 1, 16), s0.repeat(1, 16, 16))
    with pytest.raises(ValueError, match="disagree"):
        wkv.rwkv6_cuda(*flat, u, s0[:, :4])
