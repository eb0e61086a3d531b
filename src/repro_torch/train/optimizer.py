"""Optimizers from scratch: AdamW and Adafactor.

Port of the reference's ``train/optimizer.py``. AdamW keeps float32 first
and second moments; Adafactor keeps factored float32 second moments for
every leaf with two trailing dims above 1. Updates are computed in float32
and cast back to the parameter's dtype. The state is a nested dict with
the reference's keys, so leaf ``i`` lines up through ``repro_torch.tree``.

The updates write their results into the given parameter and state
tensors, as ``donate_argnums`` lets XLA do: a step holds one leaf's
temporaries at a time, never a second copy of the whole state. They
return the same trees.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import TrainConfig
from ..tree import leaves, map_leaves


def lr_schedule(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    total = max(tcfg.total_steps - tcfg.warmup_steps, 1)
    progress = torch.clamp((step - tcfg.warmup_steps) / total, 0.0, 1.0)
    cosine = 0.55 + 0.45 * torch.cos(math.pi * progress)
    return tcfg.learning_rate * warm * cosine


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf in flatten order as the reference's Python ``sum`` does."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale every leaf of ``tree`` in place by min(1, max_norm / (norm +
    1e-9)), the scale cast to the leaf's dtype; returns (tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves(tree):
        g.mul_(scale.to(g.dtype))
    return tree, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: Any) -> dict:
    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": map_leaves(zeros, params), "v": map_leaves(zeros, params)}


@torch.no_grad()
def adamw_update(params: Any, grads: Any, opt: dict, step: torch.Tensor,
                 tcfg: TrainConfig) -> tuple[Any, dict]:
    lr = lr_schedule(tcfg, step)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    t = step.to(torch.float32) + 1.0
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    map_leaves(upd, params, grads, opt["m"], opt["v"])
    return params, opt


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; used by the >= 100B configs)
# ---------------------------------------------------------------------------


def _factored(shape: tuple[int, ...]) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Any) -> dict:
    def init(p: torch.Tensor) -> dict:
        shape = tuple(p.shape)
        if _factored(shape):
            return {
                "vr": torch.zeros(shape[:-1], dtype=torch.float32, device=p.device),  # row stats
                "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32, device=p.device),
            }
        return {"v": torch.zeros(shape, dtype=torch.float32, device=p.device)}

    return {"v": map_leaves(init, params)}


@torch.no_grad()
def adafactor_update(params: Any, grads: Any, opt: dict, step: torch.Tensor,
                     tcfg: TrainConfig) -> tuple[Any, dict]:
    lr = lr_schedule(tcfg, step)
    t = step.to(torch.float32) + 1.0
    beta2 = 1.0 - torch.pow(t, -0.8)  # adafactor schedule
    eps = 1e-30
    d = tcfg.grad_clip if tcfg.grad_clip > 0 else 1.0

    def upd(p, g, v):
        g = g.to(torch.float32)
        g2 = torch.square(g) + eps
        if _factored(tuple(p.shape)):
            vr = beta2 * v["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * v["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            # u = g / (sqrt(vr/mean(vr)) ⊗ sqrt(vc)) — standard factored precond.
            rfac = torch.rsqrt(vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps) + eps)
            cfac = torch.rsqrt(vc + eps)
            u = g * rfac[..., None] * cfac[..., None, :]
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            vv = beta2 * v["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(vv + eps)
            v["v"].copy_(vv)
        # update clipping (RMS <= d)
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp(rms / d, min=1.0)
        pf = p.to(torch.float32)
        scale = torch.clamp(torch.sqrt(torch.mean(torch.square(pf))), min=1e-3)
        p.copy_(pf - lr * scale * u - lr * tcfg.weight_decay * pf)

    # map_leaves walks the parameter tree, so each parameter's state comes
    # whole, its {"vr", "vc"} or {"v"} dict, as ``flatten_up_to`` gives it
    map_leaves(upd, params, grads, opt["v"])
    return params, opt


def opt_init(params: Any, tcfg: TrainConfig) -> dict:
    if tcfg.optimizer == "adafactor":
        return adafactor_init(params)
    return adamw_init(params)


def opt_update(params: Any, grads: Any, opt: dict, step: torch.Tensor,
               tcfg: TrainConfig) -> tuple[Any, dict]:
    if tcfg.optimizer == "adafactor":
        return adafactor_update(params, grads, opt, step, tcfg)
    return adamw_update(params, grads, opt, step, tcfg)
