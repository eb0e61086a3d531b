"""Mamba-1 selective scan: the port's plain twin against the reference's
Pallas kernel (interpret mode on the CPU) and its step-by-step oracle, also
at both ends of jamba's decay range; the CUDA kernel against the plain
twin on a card (``-m cuda``), with x in float32 and bfloat16. Inputs come
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

# (B, T, DI, N, chunk, d_block, nonzero h0, draw, label): the reference's
# MAMBA_CASES, its nonzero-state carry, chunk 1 on a prime T, which the
# model's chunk rule picks for a prime T above 64 (e.g. 293), and the two
# draws of jamba's own init at the ends of the decay range (see _inputs)
CASES = [
    (1, 64, 32, 4, 32, 32, False, "reference", "reference case 1"),
    (2, 128, 64, 8, 32, 32, False, "reference", "reference case 2"),
    (2, 64, 96, 16, 16, 48, False, "reference", "reference case 3"),
    (1, 32, 16, 4, 16, 16, True, "reference", "nonzero state carry"),
    (2, 37, 24, 4, 1, 24, True, "reference", "chunk 1, prime T"),
    (1, 256, 32, 16, 64, 32, True, "slow decay", "slow decay"),
    (2, 64, 24, 16, 16, 24, True, "deep underflow", "deep underflow"),
]


def _inputs(b, t, di, n, seed, nonzero_h0=False, draw="reference"):
    """(dt, B, C, A, x, h0) as float32 numpy arrays.

    ``reference``: dt = softplus of a normal, A = -exp(0.5 * normal), as the
    reference's tests draw them. ``slow decay``: jamba's init
    (``repro/models/ssm.py``): A = -(1..N) in every channel and dt
    log-uniform in [1e-3, 1e-1], as ``dt_bias_init`` makes it, so
    exp(dt * A) is up to 0.999 and a relative error in it grows about
    1000-fold in the state. ``deep underflow``: A = -(1..N) and the
    reference's dt times 30, so dt * |A| * log2(e) > 127 (past float32's
    smallest exponent) for about 70% of the (t, d, n); x is divided by 30 so
    that dt * x keeps the reference draw's size and the tolerance measures
    rounding, not the size of the outputs."""
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.standard_normal((b, t, di)), 0.0)
    bm, cm = rng.standard_normal((b, t, n)), rng.standard_normal((b, t, n))
    a = -np.exp(rng.standard_normal((di, n)) * 0.5)
    x = rng.standard_normal((b, t, di))
    h0 = rng.standard_normal((b, di, n)) if nonzero_h0 else np.zeros((b, di, n))
    if draw == "slow decay":
        a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (di, 1))
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, t, di)))
    elif draw == "deep underflow":
        a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (di, 1))
        dt, x = dt * 30.0, x / 30.0
    else:
        assert draw == "reference", draw
    return tuple(v.astype(np.float32) for v in (dt, bm, cm, a, x, h0))


def _close_both_ways(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(want, got, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,t,di,n,chunk,dblk,nonzero_h0,draw,label", CASES,
                         ids=[c[-1] for c in CASES])
def test_plain_twin_matches_pallas_kernel_and_oracle(b, t, di, n, chunk, dblk, nonzero_h0, draw,
                                                     label):
    arrays = _inputs(b, t, di, n, seed=di + n + t, nonzero_h0=nonzero_h0, draw=draw)
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


def test_draws_reach_the_decay_range_they_name():
    """Slow decay keeps exp(dt * A) up to 0.999 for n = 1; deep underflow
    puts dt * |A| * log2(e) past 127 for most (t, d, n)."""
    dt, *_, a, _, _ = _inputs(1, 256, 32, 16, seed=0, draw="slow decay")
    da = np.exp(dt[..., None] * a)
    assert 1e-3 <= dt.min() and dt.max() <= 1e-1 and da.max() > 0.998
    dt, *_, a, _, _ = _inputs(2, 64, 24, 16, seed=1, draw="deep underflow")
    assert (dt[..., None] * -a * np.log2(np.e) > 127).mean() > 0.6


def test_cpu_bf16_x_gives_the_bits_of_x_float():
    """On the CPU, too, a bfloat16 x is taken as it is and cast to float32
    exactly: the same bits as ``x.float()``."""
    dt, bm, cm, a, x, h0 = (torch.from_numpy(v)
                            for v in _inputs(2, 32, 24, 16, seed=3, nonzero_h0=True))
    xb = x.bfloat16()
    y1, h1 = ops.mamba_chunk_scan(dt, bm, cm, a, xb, h0, chunk=16)
    y2, h2 = ops.mamba_chunk_scan(dt, bm, cm, a, xb.float(), h0, chunk=16)
    assert y1.dtype == torch.float32 and torch.equal(y1, y2) and torch.equal(h1, h2)


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


# (B, T, DI, N, draw, x dtype): jamba's decay range at both ends in float32,
# and x in bfloat16 (cast on load) at a DI that takes the 16-byte copies and
# at a ragged one that does not
CUDA_DRAW_CASES = [
    (1, 2048, 256, 16, "slow decay", torch.float32),
    (2, 300, 256, 16, "deep underflow", torch.float32),
    (2, 300, 256, 16, "slow decay", torch.bfloat16),
    (2, 64, 100, 16, "reference", torch.bfloat16),
    (1, 37, 40, 5, "deep underflow", torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,di,n,draw,x_dtype", CUDA_DRAW_CASES,
                         ids=[f"{c[4]}-{str(c[5])[6:]}-DI{c[2]}" for c in CUDA_DRAW_CASES])
def test_cuda_kernel_matches_plain_twin_across_the_decay_range(b, t, di, n, draw, x_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = _inputs(b, t, di, n, seed=t + di + n, nonzero_h0=True, draw=draw)
    dt, bm, cm, a, x, h0 = (torch.from_numpy(v) for v in arrays)
    x = x.to(x_dtype)
    got_y, got_h = ms.mamba_scan_cuda(*(v.cuda() for v in (dt, bm, cm, a, x, h0)))
    torch.cuda.synchronize()
    want_y, want_h = ms.mamba_scan_plain(dt, bm, cm, a, x, h0, chunk=t, d_block=di)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    np.testing.assert_allclose(got_y.cpu().numpy(), want_y.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_h.cpu().numpy(), want_h.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("di", [256, 100])
def test_cuda_bf16_x_gives_the_bits_of_x_float(di):
    """bf16 -> f32 is exact, so casting on load changes nothing: the same
    bits as the wrapper's input cast to float32 first (DI = 256 stages by
    16-byte copies, DI = 100 by plain loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt, bm, cm, a, x, h0 = (torch.from_numpy(v).cuda()
                            for v in _inputs(2, 45, di, 16, seed=di, nonzero_h0=True))
    xb = x.bfloat16()
    y1, h1 = ops.mamba_chunk_scan(dt, bm, cm, a, xb, h0)
    y2, h2 = ops.mamba_chunk_scan(dt, bm, cm, a, xb.float(), h0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_cuda_kernel_takes_x_in_float32_or_bf16_only_and_keeps_four_blocks_per_sm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt, bm, cm, a, x, h0 = (torch.from_numpy(v).cuda() for v in _inputs(1, 16, 8, 4, seed=2))
    with pytest.raises(TypeError, match="bfloat16"):
        ms.mamba_scan_cuda(dt, bm, cm, a, x.half(), h0)
    with pytest.raises(TypeError, match="float32"):
        ms.mamba_scan_cuda(dt, bm.bfloat16(), cm, a, x, h0)
    for x_dtype in (torch.float32, torch.bfloat16):
        assert ms.occupancy(16, x_dtype) >= 4  # 512 blocks at jamba's width run in one wave
