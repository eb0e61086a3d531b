"""Gradients through attention (B1) and the remat policy.

On the CPU both of ``ops.flash_attention``'s paths give q/k/v gradients
that match ``jax.grad`` through the reference's ``blockwise_attention``
(its XLA path, which the reference trains on) at the float32 bar, atol
2e-5 / rtol 1e-4: the plain twin (``use_pallas=True``) and the port of
``blockwise_attention`` (``use_pallas=False``), for causal, GQA, sliding
window, ragged S and bidirectional attention. Remat ``"full"`` and
``"none"`` give the same loss and gradients, and ``"full"`` runs each
group's forward again in the backward pass. On a card (``-m cuda``),
``FlashAttentionFn`` launches the kernel once per call and its gradients
match autograd through the plain twin; the WKV and scan kernels refuse
to run under grad (ROADMAP C12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.configs import TrainConfig, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as wkv
from repro_torch.models import attention as attn
from repro_torch.models import init_params, model_spec
from repro_torch.train.train_step import loss_fn
from repro_torch.tree import leaves_with_names

ATOL, RTOL = 2e-5, 1e-4

# (B, S, H, KV, D, window, causal, q_chunk of the XLA path, label)
CASES = [
    (2, 64, 4, 4, 16, 0, True, 16, "causal MHA"),
    (2, 64, 4, 2, 16, 0, True, 32, "GQA group 2"),
    (1, 128, 8, 2, 32, 0, True, 32, "GQA group 4"),
    (2, 96, 4, 2, 16, 24, True, 32, "sliding window 24"),
    (1, 75, 4, 2, 16, 0, True, 0, "ragged S=75"),
    (1, 60, 4, 1, 16, 0, False, 0, "bidirectional, GQA group 4"),
]


def _inputs(b, s, h, kv, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, s, h, d)).astype(np.float32)
    k = r.standard_normal((b, s, kv, d)).astype(np.float32)
    v = r.standard_normal((b, s, kv, d)).astype(np.float32)
    w = r.standard_normal((b, s, h, d)).astype(np.float32)  # the loss's cotangent
    return q, k, v, w


def _reference_grads(q, k, v, w, q_chunk, window, causal):
    def loss(q, k, v):
        return jnp.sum(ref_attn.blockwise_attention(q, k, v, q_chunk, window=window,
                                                    causal=causal) * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("b,s,h,kv,d,window,causal,q_chunk,label", CASES, ids=[c[-1] for c in CASES])
@pytest.mark.parametrize("path", ["plain twin", "blockwise"])
def test_cpu_gradients_match_jax_grad_through_blockwise_attention(b, s, h, kv, d, window, causal,
                                                                  q_chunk, label, path):
    q, k, v, w = _inputs(b, s, h, kv, d, seed=s + h + kv + window)
    want = _reference_grads(*(jnp.asarray(a) for a in (q, k, v, w)), q_chunk, window, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = fa.launches
    if path == "plain twin":
        out = ops.flash_attention(tq, tk, tv, causal=causal, window=window, block_k=32)
    else:
        out = attn.blockwise_attention(tq, tk, tv, q_chunk, window=window, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert fa.launches == before  # CPU tensors never launch the kernel
    for name, g, ref in zip("qkv", got, want):
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), ref, atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


def _smoke_loss_and_grads(remat, use_pallas):
    cfg = get_config("stablelm-3b", "smoke").copy(param_dtype="float32", compute_dtype="float32",
                                                  remat=remat, use_pallas=use_pallas)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    live = {n: p.requires_grad_() for n, p in leaves_with_names(params)}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)))
    loss, _ = loss_fn(params, cfg, TrainConfig(), {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(live.values()))
    return cfg, loss.detach(), dict(zip(live, grads))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_remat_full_and_none_give_the_same_loss_and_gradients(use_pallas, monkeypatch):
    calls = []
    real = attn.attn_fwd

    def counting(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)

    monkeypatch.setattr(attn, "attn_fwd", counting)
    cfg, loss_full, grads_full = _smoke_loss_and_grads("full", use_pallas)
    n_full = len(calls)
    calls.clear()
    _, loss_none, grads_none = _smoke_loss_and_grads("none", use_pallas)
    # "full" runs every attention layer again in the backward pass
    assert n_full == 2 * cfg.num_layers and len(calls) == cfg.num_layers
    torch.testing.assert_close(loss_full, loss_none, atol=1e-7, rtol=1e-6)
    assert list(grads_full) == list(grads_none)
    for name in grads_full:
        torch.testing.assert_close(grads_full[name], grads_none[name], atol=1e-7, rtol=1e-6,
                                   msg=name)


def test_remat_dots_raises_under_grad_and_serving_is_unchanged():
    cfg = get_config("stablelm-3b", "smoke").copy(param_dtype="float32", compute_dtype="float32",
                                                  remat="dots")
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    tokens = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="dots"):
        loss_fn(params, cfg, TrainConfig(), tokens)
    from repro_torch.models import forward

    with torch.inference_mode():  # serving never recomputes, whatever the policy
        a, _ = forward(params, cfg, tokens)
        b, _ = forward(params, cfg.copy(remat="none"), tokens)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (B, S, H, KV, D, window, dtype): MHA, GQA group 4, window 48, ragged S, bf16
CUDA_CASES = [
    (1, 128, 4, 4, 32, 0, torch.float32),
    (1, 256, 8, 2, 64, 0, torch.float32),
    (2, 128, 4, 2, 32, 48, torch.float32),
    (1, 300, 4, 2, 64, 0, torch.float32),
    (2, 128, 4, 2, 32, 0, torch.bfloat16),
    (1, 300, 32, 32, 80, 0, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", CUDA_CASES)
def test_cuda_flash_attention_fn_gradients_match_the_plain_twin(b, s, h, kv, d, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, w = (torch.from_numpy(a).to("cuda", dtype) for a in _inputs(b, s, h, kv, d, seed=s))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    before = fa.launches
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert fa.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad((out.float() * w.float()).sum(), (tq, tk, tv))
    assert fa.launches == before + 1  # the backward recomputes through the twin
    pq, pk, pv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = ops.flash_attention(pq.cpu(), pk.cpu(), pv.cpu(), causal=True, window=window)
    want = torch.autograd.grad((ref.float() * w.float().cpu()).sum(), (pq, pk, pv))
    tol = dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    for name, g, r in zip("qkv", got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float().cpu(), r.float().cpu(), **tol, msg=f"d{name}")


@pytest.mark.cuda
def test_cuda_wkv_and_scan_kernels_refuse_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = torch.randn(2, 16, 8, device="cuda", requires_grad=True)
    args = (r, torch.randn(2, 16, 8, device="cuda"), torch.randn(2, 16, 8, device="cuda"),
            -torch.rand(2, 16, 8, device="cuda"), torch.zeros(2, 1, 8, device="cuda"),
            torch.zeros(2, 8, 8, device="cuda"))
    with pytest.raises(RuntimeError, match="queue B"):
        wkv.rwkv6_cuda(*args)
    with torch.no_grad():
        wkv.rwkv6_cuda(*args)
    dt = torch.rand(1, 16, 8, device="cuda", requires_grad=True)
    margs = (dt, torch.randn(1, 16, 4, device="cuda"), torch.randn(1, 16, 4, device="cuda"),
             -torch.rand(8, 4, device="cuda"), torch.randn(1, 16, 8, device="cuda"),
             torch.zeros(1, 8, 4, device="cuda"))
    with pytest.raises(RuntimeError, match="queue B"):
        ms.mamba_scan_cuda(*margs)
    with torch.inference_mode():
        ms.mamba_scan_cuda(*margs)
