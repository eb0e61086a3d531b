"""Plain float32 forward passes: the embedding, a family's block per
layer (``reference/<family>.py``, found by the configuration's
``family``), the final LayerNorm and an untied head.

Every product goes through ``_einsum``, which computes in full float32
(TF32 off) or, for the control, in TF32: the card's own TF32 on a CUDA
tensor, inputs rounded to TF32's 10 mantissa bits on the CPU. The models
read the parameter tree that ``colonybench.weights`` makes (the port's
layout: stacked ``(layers, ...)`` leaves under ``groups.b0``) and take
nothing else from the program. Departures from the published models are
listed under ``assumed`` in each configuration file. Sequences are run
together, right-padded: every step is causal, so the padding after a
sequence never reaches its positions.
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
    (its ``block``, ``layout``, ``EPS_KEY`` and the rest that differ
    between families)."""
    return importlib.import_module(f"colonybench.reference.{cfg['family']}")


@torch.no_grad()
def logits_at(params: dict, cfg: dict, tokens: torch.Tensor,
              rows: list[list[int]]) -> list[torch.Tensor]:
    """float32 logits of each sequence of ``tokens`` (B, S; right-padded)
    at its positions ``rows[i]``: a (len(rows[i]), vocab) tensor each. The
    blocks run one layer at a time over the whole batch."""
    x = params["embed"][tokens.long()].float()
    fam = family(cfg)
    for i in range(cfg["num_hidden_layers"]):
        x = fam.block(_layer(params["groups"]["b0"], i), x, cfg)
    out = []
    for b, pos in enumerate(rows):
        h = _layer_norm(x[b, pos], params["norm_f"]["scale"], params["norm_f"]["bias"],
                        cfg[fam.EPS_KEY])
        out.append(_einsum("sd,dv->sv", h, params["lm_head"]))
    return out
