"""Mixture-of-Experts with grouped capacity dispatch (GShard/GLaM style).

Port of the reference's ``models/moe.py`` (its spec is ``spec.moe_spec``).
Tokens are split into groups of ``group_size``; each group routes on its
own with capacity ``C = max(1, int(group * top_k * cf / E))`` slots per
expert, and a (token, choice) pair past its expert's last slot is
dropped. The reference has no kernel here: dispatch, the experts and the
combine are dense products (``einsum``/``bmm``).

Kept as the reference computes them, since they change results:
  * top-k by a stable descending sort, so tied probabilities (a padded
    row's are all exactly 1/E) take the lower expert first, as
    ``jax.lax.top_k`` does (ROADMAP C7); ``torch.topk`` promises no order;
  * a (token, choice)'s slot is the float32 cumulative count before it,
    and its capacity one-hot compares the slot with ``arange(C)``, so a
    slot past ``C`` gives a zero row, as ``jax.nn.one_hot`` does;
  * dispatch and combine are cast to the activations' dtype before the
    products;
  * the load-balance loss, the router z-loss and the dropped share count
    every grouped row, padded rows included;
  * at decode a group holds one token per sequence, so at batch 4 with
    mixtral's 8 experts the capacity is 1 slot and some choices drop
    (ROADMAP C16): decoding a batch is not the batch's forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .attention import einsum_promote, matmul_promote
from .layers import activate
from .sharding import as_contiguous, grad_as_placed, shard_activation, split_sharded


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Top-k routing of grouped tokens x (G, S, d). Returns dispatch and
    combine (G, S, E, C), float32, and the aux values."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    g, s, _ = x.shape
    capacity = max(1, int(s * k * cfg.moe.capacity_factor / e))

    logits = torch.matmul(x.float(), router.float())  # (G, S, E)
    probs = torch.softmax(logits, dim=-1)

    # top-k gates, renormalised (mixtral/deepseek convention)
    top_gates, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_gates, top_idx = top_gates[..., :k], top_idx[..., :k]  # (G, S, k)
    top_gates = top_gates / torch.clamp(top_gates.sum(-1, keepdim=True), min=1e-9)

    # slot of each (token, choice) in its expert's buffer
    onehot = F.one_hot(top_idx, e).float()  # (G, S, k, E)
    flat = onehot.reshape(g, s * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(g, s, k, e)
    pos = (pos_in_expert * onehot).sum(-1)  # (G, S, k)
    keep = pos < capacity
    gates = top_gates * keep

    slots = torch.arange(capacity, device=x.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float()  # (G, S, k, C); zero past capacity
    dispatch = torch.einsum("gske,gskc->gsec", onehot * keep[..., None], pos_oh)
    combine = torch.einsum("gske,gskc->gsec", onehot * gates[..., None], pos_oh)

    # switch load balance (first-choice share) + router z-loss
    me = probs.mean(dim=(0, 1))  # mean gate probability per expert
    ce = F.one_hot(top_idx[..., 0], e).float().mean(dim=(0, 1))  # share of first choices
    aux = {
        "lb_loss": e * torch.sum(me * ce),
        "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "dropped_frac": 1.0 - keep.sum() / (g * s * k),
    }
    return dispatch, combine, aux


def moe_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (B, S, d), aux values."""
    b, s, d = x.shape
    group = min(cfg.moe.group_size, b * s)
    tokens = x.reshape(b * s, d)
    pad = (-tokens.shape[0]) % group
    # a dry-run's DTensor: the token dim stays sharded only where its shards
    # hold whole groups (and nothing is padded)
    tokens = split_sharded(tokens, 0, 1 if pad else tokens.shape[0] // group)
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    grouped = tokens.reshape(-1, group, d)  # (G, group, d)

    dispatch, combine, aux = _route(grouped, params["router"], cfg)
    # a dry-run's DTensors: the experts stay sharded through dispatch and
    # combine, as the expert weights are (expert parallelism)
    dispatch, combine = (shard_activation(grad_as_placed(t), ("batch", None, "experts", None), cfg)
                         for t in (dispatch, combine))
    dtype = x.dtype
    expert_axes = ("batch", "experts", None, None)
    expert_in = shard_activation(
        grad_as_placed(torch.einsum("gsec,gsd->gecd", dispatch.to(dtype), grouped)), expert_axes,
        cfg)
    gate, up = (grad_as_placed(einsum_promote("gecd,edf->gecf", expert_in, params[w]))
                for w in ("w_gate", "w_up"))
    act = as_contiguous(activate(gate, up, cfg.activation))
    expert_out = shard_activation(
        grad_as_placed(einsum_promote("gecf,efd->gecd", act, params["w_down"])), expert_axes,
        cfg)
    out = einsum_promote("gsec,gecd->gsd", combine.to(dtype), expert_out)
    out = out.reshape(-1, d)[: b * s].reshape(b, s, d)

    if cfg.moe.num_shared_experts > 0:
        sg = matmul_promote(x, params["shared_gate"])
        su = matmul_promote(x, params["shared_up"])
        out = out + matmul_promote(activate(sg, su, cfg.activation), params["shared_down"])
    return out, aux


def moe_aux_loss(aux: dict, cfg: ModelConfig) -> torch.Tensor:
    return cfg.moe.aux_loss_weight * aux["lb_loss"] + cfg.moe.router_z_weight * aux["z_loss"]
