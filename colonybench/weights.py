"""The benchmark's weights: made on the device from ``--seed``, in one
draw, in the program's parameter layout.

One float32 buffer of every parameter is filled by a single ``randn``
from a ``torch.Generator`` seeded with the run's seed on the device; each
leaf is a view of it, scaled in place by its rule below. The tree has the
port's layout (``embed``, ``lm_head``, ``norm_f`` and the blocks of a
group, ``groups.b0``, ``groups.b1``, ..., each leaf stacked over the
groups), which the engine's ``params`` setter takes as it is and the
reference reads. The scales keep every
activation near unit size over all layers, so the logits have a spread
and a lower precision shows in them. A configuration may scale its
residual branches' output projections by ``init_residual_scale`` (GPT-2's
1/sqrt(2·layers)), where without it the model amplifies float32 rounding
from layer to layer.
"""

from __future__ import annotations

import math

import torch

from .reference import models


def layout(cfg: dict) -> dict:
    """The parameter tree's shapes, keys in the port's names. The family's
    module gives the group's blocks, ``groups(cfg)`` (by default one block,
    ``{"b0": layout(cfg)}``), and the final norm's shapes, ``final_norm(cfg)``
    (by default a LayerNorm's scale and bias)."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    fam = models.family(cfg)
    groups = fam.groups(cfg) if hasattr(fam, "groups") else {"b0": fam.layout(cfg)}
    norm_f = fam.final_norm(cfg) if hasattr(fam, "final_norm") else {"scale": (d,), "bias": (d,)}
    return {"embed": (v, d), "groups": groups, "lm_head": (d, v), "norm_f": norm_f}


def leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def _fill(name: str, t: torch.Tensor, cfg: dict) -> None:
    """Turn a view of N(0, 1) draws into the leaf ``name``'s values: the
    family's own rules first, then norm scales near 1, small biases, unit
    embeddings, and for a product's weight a fan-in scaling over its input
    width, taken as ``shape[1]`` of a stacked leaf: a family's ``fill``
    covers every leaf whose input width lies elsewhere, as that of stacked
    experts, (groups, experts, d, f), does."""
    if models.family(cfg).fill(name, t, cfg):
        return
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        t.mul_(0.1).add_(1.0)
    elif leaf == "bias":
        t.mul_(0.1)
    elif name != "embed":
        fan_in = t.shape[1] if t.dim() >= 3 else t.shape[0]
        t.mul_(1.0 / math.sqrt(fan_in))


def make(cfg: dict, seed: int, device: torch.device) -> tuple[dict, torch.Tensor]:
    """(parameter tree, the one buffer every leaf is a view of)."""
    shapes = list(leaves(layout(cfg)))
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    offset = 0
    for name, shape in shapes:
        n = math.prod(shape)
        view = flat[offset:offset + n].view(shape)
        _fill(name, view, cfg)
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = view
        offset += n
    return tree, flat
