"""Plain float32 forward passes: the embedding, a family's blocks group by
group (``reference/<family>.py``, found by the configuration's
``family``), its final norm and an untied head.

Every product goes through ``_einsum``, which computes in full float32
(TF32 off) or, for the control, in TF32: the card's own TF32 on a CUDA
tensor, inputs rounded to TF32's 10 mantissa bits on the CPU. The models
read the parameter tree that ``colonybench.weights`` makes (the port's
layout: the blocks ``groups.b0``, ``groups.b1``, ... of a group, each leaf
stacked over the groups) and take nothing else from the program.
Departures from the published models are listed under ``assumed`` in each
configuration file. Sequences are run together, right-padded: every step
is causal, so the padding after a sequence never reaches its positions.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Iterator

import torch

_PRECISION = {"mode": "float32"}


@contextlib.contextmanager
def precision(mode: str) -> Iterator[None]:
    """``float32`` (TF32 off, the configuration's precision) or ``tf32``
    (the control: the nearest precision below it)."""
    if mode not in ("float32", "tf32"):
        raise ValueError(mode)
    old = (_PRECISION["mode"], torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    _PRECISION["mode"] = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_PRECISION["mode"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties away) at TF32's 10 mantissa bits; a
    gradient passes through unrounded."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _PRECISION["mode"] == "tf32" and a.device.type == "cpu":
        a, b = round_tf32(a), round_tf32(b)
    return torch.einsum(eq, a, b)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's input; zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def family(cfg: dict):
    """The module of ``cfg``'s family, found by name: ``reference/<family>.py``
    (its blocks, layout, final norm and counts, each with a default the
    README's "Adding a configuration" lists)."""
    return importlib.import_module(f"colonybench.reference.{cfg['family']}")


def _block_keys(groups: dict) -> list[str]:
    """A group's blocks in the port's index order: ``b0``, ``b1``, ...,
    ``b9``, ``b10``."""
    return sorted(groups, key=lambda key: int(key[1:]))


def _num_groups(tree: dict) -> int:
    """The leading axis of the first stacked leaf."""
    leaf = next(iter(tree.values()))
    return _num_groups(leaf) if isinstance(leaf, dict) else leaf.shape[0]


def _run(block, p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    return block(p, x, cfg)


def _final_layer_norm(p: dict, h: torch.Tensor, cfg: dict) -> torch.Tensor:
    return _layer_norm(h, p["scale"], p["bias"], cfg[family(cfg).EPS_KEY])


def hidden(params: dict, cfg: dict, x: torch.Tensor, rows: list[list[int]] | None = None,
           call=_run):
    """The embedded ``x`` (B, S, d) through every group in turn, inside each
    its blocks in index order, then the family's final norm: over every
    position, or over each sequence's positions ``rows[i]``, a list of
    (len(rows[i]), d) tensors. The family gives its blocks by key as
    ``blocks(cfg)`` (by default ``{"b0": block}``) and its final norm as
    ``apply_final_norm(p, h, cfg)`` (by default a LayerNorm with bias, eps
    ``cfg[EPS_KEY]``). ``call(block, p, x, cfg)`` runs each block, for
    training under recomputation."""
    fam = family(cfg)
    blocks = fam.blocks(cfg) if hasattr(fam, "blocks") else {"b0": fam.block}
    groups = params["groups"]
    keys = _block_keys(groups)
    for g in range(_num_groups(groups)):
        for key in keys:
            x = call(blocks[key], _layer(groups[key], g), x, cfg)
    norm = getattr(fam, "apply_final_norm", _final_layer_norm)
    if rows is None:
        return norm(params["norm_f"], x, cfg)
    return [norm(params["norm_f"], x[b, pos], cfg) for b, pos in enumerate(rows)]


@torch.no_grad()
def logits_at(params: dict, cfg: dict, tokens: torch.Tensor,
              rows: list[list[int]]) -> list[torch.Tensor]:
    """float32 logits of each sequence of ``tokens`` (B, S; right-padded)
    at its positions ``rows[i]``: a (len(rows[i]), vocab) tensor each. The
    blocks run one layer at a time over the whole batch."""
    x = params["embed"][tokens.long()].float()
    return [_einsum("sd,dv->sv", h, params["lm_head"]) for h in hidden(params, cfg, x, rows)]
