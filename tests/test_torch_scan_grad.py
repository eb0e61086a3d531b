"""Gradients through the WKV (B2) and selective-scan (B3) paths.

On the CPU the port's WKV paths (the model's chunked ``_wkv_chunked`` and
the kernel's plain twin ``rwkv6_plain``) and the scan's plain twin
(``mamba_scan_plain``) give gradients that match ``jax.grad`` through the
reference's XLA paths, ``rwkv._wkv_chunked`` and ``ssm._chunk_scan``,
which the reference trains on, at atol 1e-5 / rtol 1e-4. The decays stay
in the init range (w0 in [-6, -1], so log w in [-e^-1, -e^-6]): at strong
decay the reference's WKV gradient is NaN (ROADMAP C13), and the port's
stays finite, which a test of its own shows at w0 + lora = 2 and 4, the
clip's top. The forward is bit for bit what it was: ``exp(where(tri,
diff, -inf))`` equals ``where(tri, exp(diff), 0)`` element by element,
overflowing entries included.

On a card (``-m cuda``) ``ops.rwkv6_chunked`` and ``ops.mamba_chunk_scan``
at the model's layout (their custom ops, whose gradient recomputes through
the twin) launch their kernel once in the forward and none in the
backward, and their gradients match autograd through the plain twin on
the card at the twins' float32 bar, atol 1e-4 / rtol 1e-3; at w0 = 4 they
are finite."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as wkv
from repro_torch.models import rwkv

ATOL, RTOL = 1e-5, 1e-4


def _wkv_inputs(b, t, h, k, w, seed):
    """r, k, v, logw = -exp(w) (w per channel, or a constant), u, s0 and the
    cotangents of out and of the final state, as float32 numpy."""
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, t, h, k)).astype(np.float32) * 0.5 for _ in range(3))
    if w is None:  # the init's spread of w0: -6 .. -1
        w = rng.uniform(-6.0, -1.0, (b, t, h, k))
    logw = (-np.exp(np.broadcast_to(w, (b, t, h, k)))).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, k, k)) * 0.5).astype(np.float32)
    g_out = rng.standard_normal((b, t, h, k)).astype(np.float32)
    g_s = rng.standard_normal((b, h, k, k)).astype(np.float32)
    return (r, kk, v, logw, u, s0), (g_out, g_s)


def _ref_wkv_grads(args, cots, chunk):
    g_out, g_s = (jnp.asarray(c) for c in cots)

    def loss(*a):
        out, s = ref_rwkv._wkv_chunked(*a, chunk)
        return jnp.sum(out * g_out) + jnp.sum(s * g_s)

    return [np.asarray(g) for g in jax.grad(loss, argnums=range(6))(*map(jnp.asarray, args))]


def _port_wkv_grads(path, args, cots, chunk):
    live = [torch.from_numpy(a).requires_grad_() for a in args]
    if path == "model chunked":
        out, s = rwkv._wkv_chunked(*live, chunk)
    else:  # the kernel's plain twin, through ops on a CPU tensor
        out, s = ops.rwkv6_chunked(*live, chunk=chunk)
    loss = (out * torch.from_numpy(cots[0])).sum() + (s * torch.from_numpy(cots[1])).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, live)]


@pytest.mark.parametrize("path", ["model chunked", "plain twin"])
@pytest.mark.parametrize("b,t,h,k,chunk", [(2, 64, 2, 8, 16), (1, 60, 3, 16, 30)])
def test_wkv_gradients_match_jax_grad_in_the_init_range(path, b, t, h, k, chunk):
    args, cots = _wkv_inputs(b, t, h, k, None, seed=t + k)
    want = _ref_wkv_grads(args, cots, chunk)
    got = _port_wkv_grads(path, args, cots, chunk)
    for name, g, w in zip(("r", "k", "v", "logw", "u", "s0"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("path", ["model chunked", "plain twin"])
@pytest.mark.parametrize("w", [2.0, 4.0])
def test_wkv_gradient_is_finite_at_strong_decay(path, w):
    """C13: at w0 + lora = 2 and 4 (log w = -7.4 and -54.6) exp(diff)
    overflows above the diagonal of a chunk of 32; the reference's
    gradient is then NaN, the port's finite."""
    args, cots = _wkv_inputs(1, 64, 2, 8, w, seed=1)
    want = _ref_wkv_grads(args, cots, 32)
    assert not np.isfinite(want[3]).all()  # the reference's d/dlogw
    got = _port_wkv_grads(path, args, cots, 32)
    assert all(np.isfinite(g).all() for g in got)
    # where the reference's gradient is finite, the port's agrees
    for g, ref in zip(got, want):
        ok = np.isfinite(ref)
        np.testing.assert_allclose(g[ok], ref[ok], atol=ATOL, rtol=RTOL)


def test_masked_decay_forward_is_bit_identical():
    """The C13 form gives the same bits as the reference's: exp(-inf) is
    exactly 0, and the kept entries take the same exp."""
    rng = np.random.default_rng(0)
    for logw in (-math.exp(-6.0), -math.exp(-1.0), -math.exp(2.0), -math.exp(4.0)):
        lw = torch.from_numpy((rng.uniform(0.5, 1.5, (2, 32, 3)) * logw).astype(np.float32))
        cum = torch.cumsum(lw, dim=1)
        diff = (cum - lw)[:, :, None] - cum[:, None, :]
        tri = torch.tril(torch.ones((32, 32), dtype=torch.bool), diagonal=-1)[None, :, :, None]
        old = torch.where(tri, torch.exp(diff), 0.0)
        new = torch.exp(torch.where(tri, diff, -torch.inf))
        assert torch.equal(old, new)


def _scan_inputs(b, t, di, n, seed):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(1e-3, 1e-1, (b, t, di)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, t, n)).astype(np.float32) for _ in range(2))
    a = (-np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))).astype(np.float32)
    x = rng.standard_normal((b, t, di)).astype(np.float32)
    h0 = (rng.standard_normal((b, di, n)) * 0.5).astype(np.float32)
    g_y = rng.standard_normal((b, t, di)).astype(np.float32)
    g_h = rng.standard_normal((b, di, n)).astype(np.float32)
    return (dt, bm, cm, a, x, h0), (g_y, g_h)


@pytest.mark.parametrize("b,t,di,n,chunk", [(2, 64, 32, 4, 16), (1, 60, 24, 16, 20)])
def test_scan_gradients_match_jax_grad(b, t, di, n, chunk):
    args, (g_y, g_h) = _scan_inputs(b, t, di, n, seed=t + di)

    def loss(*a):
        y, h = ref_ssm._chunk_scan(*a, chunk)
        return jnp.sum(y * g_y) + jnp.sum(h * g_h)

    want = jax.grad(loss, argnums=range(6))(*map(jnp.asarray, args))
    live = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = ops.mamba_chunk_scan(*live, chunk=chunk)
    got = torch.autograd.grad((y * torch.from_numpy(g_y)).sum() + (h * torch.from_numpy(g_h)).sum(),
                              live)
    for name, g, w in zip(("dt", "B", "C", "A", "x", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CUDA_ATOL, CUDA_RTOL = 1e-4, 1e-3


def _plain_wkv(r, k, v, logw, u, s0, chunk):
    """The kernel's plain twin at the model's layout: flattened to
    (B·H, T, K) and back here, apart from the op's own layout code."""
    b, t, h, dk = r.shape

    def flat(x):
        return x.transpose(1, 2).reshape(b * h, t, x.shape[-1])

    out, s = wkv.rwkv6_plain(flat(r), flat(k), flat(v), flat(logw),
                             u[None].expand(b, h, dk).reshape(b * h, 1, dk),
                             s0.reshape(b * h, dk, -1), chunk=chunk)
    return out.reshape(b, h, t, -1).transpose(1, 2), s.reshape(b, h, dk, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("w,chunk", [(None, 16), (None, 30), (4.0, 32)])
def test_cuda_wkv_fn_gradients_match_the_plain_twin(w, chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    np_args, (g_out, g_s) = _wkv_inputs(2, 96 if chunk != 30 else 90, 4, 64, w, seed=chunk)
    args = [torch.from_numpy(a).cuda() for a in np_args]
    g_out, g_s = torch.from_numpy(g_out).cuda(), torch.from_numpy(g_s).cuda()
    live = [a.clone().requires_grad_() for a in args]
    before = wkv.launches
    out, s = ops.rwkv6_chunked(*live, chunk=chunk)
    assert wkv.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad((out * g_out).sum() + (s * g_s).sum(), live)
    assert wkv.launches == before + 1  # the backward recomputes through the twin
    ref_in = [a.clone().requires_grad_() for a in args]
    ro, rs = _plain_wkv(*ref_in, chunk)
    want = torch.autograd.grad((ro * g_out).sum() + (rs * g_s).sum(), ref_in)
    for name, g, r in zip(("r", "k", "v", "logw", "u", "s0"), got, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, atol=CUDA_ATOL, rtol=CUDA_RTOL, msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba_scan_fn_gradients_match_the_plain_twin(x_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    np_args, (g_y, g_h) = _scan_inputs(2, 120, 256, 16, seed=5)
    dt, bm, cm, a, x, h0 = (torch.from_numpy(v).cuda() for v in np_args)
    args = (dt, bm, cm, a, x.to(x_dtype), h0)
    g_y, g_h = torch.from_numpy(g_y).cuda(), torch.from_numpy(g_h).cuda()
    live = [v.clone().requires_grad_() for v in args]
    before = ms.launches
    y, h = ops.mamba_chunk_scan(*live, chunk=60)
    assert ms.launches == before + 1 and y.grad_fn is not None
    got = torch.autograd.grad((y * g_y).sum() + (h * g_h).sum(), live)
    assert ms.launches == before + 1
    ref_in = [v.clone().requires_grad_() for v in args]
    ry, rh = ms.mamba_scan_plain(*ref_in[:4], ref_in[4].float(), ref_in[5], chunk=60, d_block=256)
    want = torch.autograd.grad((ry * g_y).sum() + (rh * g_h).sum(), ref_in)
    for name, g, r in zip(("dt", "B", "C", "A", "x", "h0"), got, want):
        assert g.dtype == r.dtype and torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), r.float(), atol=CUDA_ATOL, rtol=CUDA_RTOL,
                                   msg=f"d{name}")
