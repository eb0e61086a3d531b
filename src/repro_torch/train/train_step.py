"""train_step: causal-LM loss and microbatched gradient accumulation.

Port of the reference's ``train/train_step.py``. The step is a function
(state, batch) -> (state, metrics), with the reference's state
``{"step": int32 0-d, "params": ..., "opt": ...}``. With ``microbatches``
k > 1 the batch arrives pre-split as (k, B/k, ...) and float32 gradients
accumulate as g/k in microbatch order. With experts the loss adds the
weighted load-balance and router z losses, reported as ``moe_lb`` and
``moe_z``; with multi-token prediction (deepseek) it adds
``mtp_loss_weight`` times the MTP block's CE on token t+2, reported as
``mtp_ce``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig, TrainConfig
from ..models.model import forward, mtp_logits
from ..models.moe import moe_aux_loss
from ..tree import leaves, map_leaves, rebuild
from .optimizer import clip_by_global_norm, global_norm, lr_schedule, opt_init, opt_update


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None):
    """Mean next-token CE in float32. logits: (B,S,V); targets: (B,S) integer."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # a dry-run's vocab-sharded logits: the masked sum, whose shards
        # reduce with one all-reduce (DTensor's gather along a sharded dim
        # leaves a mask its reductions cannot apply); the same values
        hit = torch.arange(logits.shape[-1], device=logits.device) == targets[..., None]
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean(), nll.numel()
    denom = torch.clamp(mask.sum(), min=1)
    return (nll * mask).sum() / denom, denom


def loss_fn(params: Any, cfg: ModelConfig, tcfg: TrainConfig, batch: dict):
    tokens = batch["tokens"]
    want_hidden = cfg.mtp_depth > 0
    out = forward(params, cfg, batch, return_hidden=want_hidden)
    logits, aux = out[0], out[1]
    ce, _ = cross_entropy(logits[:, :-1], tokens[:, 1:])
    loss = ce
    metrics = {"ce": ce}
    if cfg.moe.num_experts > 0:
        loss = loss + moe_aux_loss(aux, cfg)
        metrics["moe_lb"] = aux["lb_loss"]
        metrics["moe_z"] = aux["z_loss"]
    if want_hidden:
        # MTP: logits at position t predict token t+2
        mlogits = mtp_logits(params, cfg, out[2], tokens)  # (B, S-1, V)
        mtp_ce, _ = cross_entropy(mlogits[:, :-1], tokens[:, 2:])
        loss = loss + tcfg.mtp_loss_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def init_state(params: Any, tcfg: TrainConfig) -> dict:
    device = leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "params": params,
        "opt": opt_init(params, tcfg),
    }


def split_microbatches(batch: dict, k: int) -> dict:
    """(B, ...) numpy leaves -> (k, B/k, ...), the layout ``train_step``
    takes when ``microbatches`` is k > 1."""
    return {key: np.asarray(v).reshape(k, -1, *np.shape(v)[1:]) for key, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    microbatch_indices: Callable[[int], Iterable[int]] = range):
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    float32 0-d tensors. The new parameters and optimizer state are written
    into the given state's tensors (as ``donate_argnums`` lets XLA do), so
    a step holds one copy of them. With k > 1 microbatches the step runs
    the microbatches ``microbatch_indices(k)`` yields (all k by default; the
    dry-run traces the first alone and counts it k times)."""

    def grads_of(params: Any, batch: dict) -> tuple[list[torch.Tensor], dict]:
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        flat = leaves(live)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, cfg, tcfg, batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        k = tcfg.microbatches
        if k > 1:
            if any(v.shape[0] != k for v in batch.values()):
                raise ValueError(f"microbatches={k}: batch leaves must arrive pre-split as "
                                 f"(k, B/k, ...) (split_microbatches)")
            flat = leaves(params)
            # zeros_like keeps a sharded parameter's placement in a dry-run
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            zero = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            metrics = {key: zero for key in _metric_keys(cfg)}
            for i in microbatch_indices(k):
                g, m = grads_of(params, {key: v[i] for key, v in batch.items()})
                for acc, gg in zip(grads, g):
                    acc.add_(gg.to(torch.float32) / k)
                del g
                metrics = {key: metrics[key] + m[key] / k for key in metrics}
        else:
            grads, metrics = grads_of(params, batch)

        with torch.no_grad():
            gtree = rebuild(params, grads)
            del grads
            if tcfg.grad_clip > 0:
                gtree, gnorm = clip_by_global_norm(gtree, tcfg.grad_clip)
            else:
                gnorm = global_norm(gtree)
            new_params, new_opt = opt_update(params, gtree, state["opt"], state["step"], tcfg)
            del gtree
            new_state = {"step": state["step"] + 1, "params": new_params, "opt": new_opt}
            metrics = dict(metrics)
            metrics["grad_norm"] = gnorm
            metrics["lr"] = lr_schedule(tcfg, state["step"])
        return new_state, metrics

    return train_step


def _metric_keys(cfg: ModelConfig) -> list[str]:
    keys = ["ce", "loss"]
    if cfg.moe.num_experts > 0:
        keys += ["moe_lb", "moe_z"]
    if cfg.mtp_depth > 0:
        keys += ["mtp_ce"]
    return keys


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig):
    @torch.no_grad()
    def eval_step(params: Any, batch: dict) -> dict:
        _, metrics = loss_fn(params, cfg, tcfg, batch)
        return metrics

    return eval_step
