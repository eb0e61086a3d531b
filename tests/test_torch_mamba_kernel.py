"""Mamba-1 selective scan: the port's plain twin against the reference's
Pallas kernel (interpret mode on the CPU) and its step-by-step oracle; the
CUDA kernel against the plain twin on a card (``-m cuda``). Inputs come
from numpy seeds; tolerances are those of ``tests/test_kernels.py`` (atol
1e-4, rtol 1e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import mamba_chunk_scan as pallas_mamba
from repro.kernels.ref import mamba_scan_ref
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops

ATOL, RTOL = 1e-4, 1e-3

# (B, T, DI, N, chunk, d_block, nonzero h0, label): the reference's
# MAMBA_CASES, its nonzero-state carry, and chunk 1 on a prime T, which the
# model's chunk rule picks for a prime T above 64 (e.g. 293)
CASES = [
    (1, 64, 32, 4, 32, 32, False, "reference case 1"),
    (2, 128, 64, 8, 32, 32, False, "reference case 2"),
    (2, 64, 96, 16, 16, 48, False, "reference case 3"),
    (1, 32, 16, 4, 16, 16, True, "nonzero state carry"),
    (2, 37, 24, 4, 1, 24, True, "chunk 1, prime T"),
]


def _inputs(b, t, di, n, seed, nonzero_h0=False):
    """(dt, B, C, A, x, h0) as float32 numpy arrays: dt = softplus of a
    normal, A = -exp(0.5 * normal), as the reference's tests draw them."""
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.standard_normal((b, t, di)), 0.0)
    bm, cm = rng.standard_normal((b, t, n)), rng.standard_normal((b, t, n))
    a = -np.exp(rng.standard_normal((di, n)) * 0.5)
    x = rng.standard_normal((b, t, di))
    h0 = rng.standard_normal((b, di, n)) if nonzero_h0 else np.zeros((b, di, n))
    return tuple(v.astype(np.float32) for v in (dt, bm, cm, a, x, h0))


def _close_both_ways(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(want, got, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,t,di,n,chunk,dblk,nonzero_h0,label", CASES, ids=[c[-1] for c in CASES])
def test_plain_twin_matches_pallas_kernel_and_oracle(b, t, di, n, chunk, dblk, nonzero_h0, label):
    arrays = _inputs(b, t, di, n, seed=di + n + t, nonzero_h0=nonzero_h0)
    want_y, want_h = pallas_mamba(*(jnp.asarray(v) for v in arrays), chunk=chunk, d_block=dblk)
    got_y, got_h = ops.mamba_chunk_scan(*(torch.from_numpy(v) for v in arrays), chunk=chunk,
                                        d_block=dblk)
    assert got_y.shape == (b, t, di) and got_h.shape == (b, di, n)
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    _close_both_ways(got_y.numpy(), np.asarray(want_y))
    _close_both_ways(got_h.numpy(), np.asarray(want_h))
    ref_y, ref_h = mamba_scan_ref(*(jnp.asarray(v) for v in arrays))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=ATOL, rtol=RTOL)


def test_d_block_shrinks_until_it_divides_di_as_the_reference():
    """DI = 100 with d_block 48: the reference's wrapper shrinks it to 25
    before the Pallas kernel asserts DI % d_block == 0; the port's does the
    same, and the plain twin alone refuses a d_block that does not divide."""
    arrays = _inputs(1, 16, 100, 4, seed=5, nonzero_h0=True)
    want_y, want_h = pallas_mamba(*(jnp.asarray(v) for v in arrays), chunk=8, d_block=48)
    tensors = [torch.from_numpy(v) for v in arrays]
    got_y, got_h = ops.mamba_chunk_scan(*tensors, chunk=8, d_block=48)
    _close_both_ways(got_y.numpy(), np.asarray(want_y))
    _close_both_ways(got_h.numpy(), np.asarray(want_h))
    with pytest.raises(ValueError, match="d_block 48"):
        ms.mamba_scan_plain(*tensors, chunk=8, d_block=48)


def test_plain_twin_rejects_a_chunk_that_does_not_divide_t():
    tensors = [torch.from_numpy(v) for v in _inputs(1, 30, 8, 4, seed=0)]
    with pytest.raises(ValueError, match="multiple of chunk 16"):
        ops.mamba_chunk_scan(*tensors, chunk=16)


def test_chunk_prefix_is_the_sequential_recurrence():
    """The in-chunk scan of (da, dbx) pairs gives every step's state from
    a zero state: h_i = da_i * h_{i-1} + dbx_i."""
    rng = np.random.default_rng(9)
    da = torch.from_numpy(rng.uniform(0.1, 1.0, (2, 7, 5)).astype(np.float32))
    dbx = torch.from_numpy(rng.standard_normal((2, 7, 5)).astype(np.float32))
    acc_a, acc_b = ms.chunk_prefix(da, dbx)
    h, prod = torch.zeros(2, 5), torch.ones(2, 5)
    for i in range(7):
        h, prod = da[:, i] * h + dbx[:, i], prod * da[:, i]
        torch.testing.assert_close(acc_b[:, i], h, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(acc_a[:, i], prod, atol=1e-6, rtol=1e-6)


def test_cpu_tensors_never_launch_the_kernel():
    tensors = [torch.from_numpy(v) for v in _inputs(1, 16, 8, 4, seed=1)]
    before = ms.launches
    ops.mamba_chunk_scan(*tensors, chunk=8)
    assert ms.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan_cuda(*tensors)


# (B, T, DI, N, chunk, nonzero h0): the reference cases, a ragged DI, and
# prime and serving lengths at jamba's N
CUDA_CASES = [
    (1, 64, 32, 4, 32, False),
    (2, 128, 64, 8, 32, False),
    (2, 64, 96, 16, 16, True),
    (2, 37, 100, 16, 1, True),  # ragged DI: the last block of 128 channels is masked
    (1, 300, 1024, 16, 60, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,di,n,chunk,nonzero_h0", CUDA_CASES)
def test_cuda_kernel_matches_plain_twin(b, t, di, n, chunk, nonzero_h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = _inputs(b, t, di, n, seed=t + di, nonzero_h0=nonzero_h0)
    before = ms.launches
    got_y, got_h = ops.mamba_chunk_scan(*(torch.from_numpy(v).cuda() for v in arrays), chunk=chunk)
    torch.cuda.synchronize()
    assert ms.launches == before + 1
    want_y, want_h = ops.mamba_chunk_scan(*(torch.from_numpy(v) for v in arrays), chunk=chunk)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    np.testing.assert_allclose(got_y.cpu().numpy(), want_y.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_h.cpu().numpy(), want_h.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_cuda_kernel_result_does_not_depend_on_chunk_or_d_block():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tensors = [torch.from_numpy(v).cuda() for v in _inputs(2, 60, 100, 16, seed=4, nonzero_h0=True)]
    y1, h1 = ops.mamba_chunk_scan(*tensors, chunk=60, d_block=100)
    y2, h2 = ops.mamba_chunk_scan(*tensors, chunk=1, d_block=7)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt, bm, cm, a, x, h0 = (torch.from_numpy(v).cuda() for v in _inputs(1, 16, 8, 4, seed=2))
    with pytest.raises(TypeError, match="float32"):
        ms.mamba_scan_cuda(dt.bfloat16(), bm, cm, a, x, h0)
    bw, cw, aw, hw = bm.repeat(1, 1, 5), cm.repeat(1, 1, 5), a.repeat(1, 5), h0.repeat(1, 1, 5)
    with pytest.raises(ValueError, match="unsupported"):  # N = 20
        ms.mamba_scan_cuda(dt, bw, cw, aw, x, hw)
    with pytest.raises(ValueError, match="unsupported"):  # T = 0
        ms.mamba_scan_cuda(dt[:, :0], bm[:, :0], cm[:, :0], a, x[:, :0], h0)
    with pytest.raises(ValueError, match="disagree"):
        ms.mamba_scan_cuda(dt, bm, cm, a, x, h0[:, :4])
