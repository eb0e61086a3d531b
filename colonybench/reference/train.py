"""Plain float32 training: the reference a training cell's first three
steps are held to.

Worked out again from the train spec's kwargs and seed, taking nothing
the program made: the initial weights by the rules the port documents for
a seeded init (each leaf in sorted-key order drawn by ``randn`` from one
``torch.Generator`` on the device, scaled by 1/sqrt of the product of all
its dimensions but the last, the stacked layer axis included; embeddings
x 0.02; norm scales 1, biases 0), each step's batch by the synthetic
stream the spec names (``tok[t+1] = (31 tok[t] + 7 + noise) % V`` from
``numpy.random.default_rng(seed * 1_000_003 + step)``), the mean
next-token cross-entropy through the family's blocks (each recomputed in
the backward pass, so that three steps fit beside the state), and
AdamW: linear warm-up then cosine decay to 10% of the rate, global-norm
clipping, bias-corrected moments, decoupled weight decay on every leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import weights
from . import models


@dataclass
class Hyper:
    steps: int
    batch: int
    seq_len: int
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0


def initial_params(cfg: dict, seed: int, device: torch.device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    tree: dict = {}
    for name, shape in weights.leaves(weights.layout(cfg)):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            t = torch.ones(shape, device=device)
        elif leaf == "bias":
            t = torch.zeros(shape, device=device)
        else:
            scale = 0.02 if name == "embed" else 1.0 / math.sqrt(max(math.prod(shape[:-1]), 1))
            t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(scale)
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def batch_at(seed: int, step: int, batch: int, seq_len: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(seed * 1_000_003 + step)
    toks = np.empty((batch, seq_len), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    noise = (rng.random((batch, seq_len)) < 0.1) * rng.integers(1, vocab, (batch, seq_len))
    for t in range(1, seq_len):
        toks[:, t] = (31 * toks[:, t - 1] + 7 + noise[:, t]) % vocab
    return toks


def _recomputed(block, p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    return checkpoint(block, p, x, cfg, use_reentrant=False)


def loss(params: dict, cfg: dict, tokens: torch.Tensor) -> torch.Tensor:
    h = models.hidden(params, cfg, params["embed"][tokens], call=_recomputed)
    logits = models._einsum("bsd,dv->bsv", h[:, :-1], params["lm_head"])
    gold = logits.gather(-1, tokens[:, 1:, None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean()


def lr_at(hp: Hyper, step: int) -> float:
    warm = min(step / max(hp.warmup_steps, 1), 1.0)
    progress = min(max((step - hp.warmup_steps) / max(hp.steps - hp.warmup_steps, 1), 0.0), 1.0)
    return hp.learning_rate * warm * (0.55 + 0.45 * math.cos(math.pi * progress))


def first_steps(cfg: dict, hp: Hyper, seed: int, device: torch.device, n: int = 3,
                batch_fn=None) -> dict:
    """The losses of the first ``n`` steps, each leaf's gradient norm at the
    first step as the optimizer gets it (after clipping), and each leaf's
    change over the ``n`` steps. ``batch_fn(step)`` can stand in for the
    synthetic stream (a fault planted in the reference)."""
    params = initial_params(cfg, seed, device)
    names = [name for name, _ in weights.leaves(params)]
    flat = [p for _, p in weights.leaves(params)]
    start = [p.clone() for p in flat]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    out: dict = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for step in range(n):
        toks = batch_fn(step) if batch_fn else batch_at(seed, step, hp.batch, hp.seq_len,
                                                         cfg["vocab_size"])
        tokens = torch.as_tensor(toks, dtype=torch.long, device=device)
        for p in flat:
            p.requires_grad_(True)
        value = loss(params, cfg, tokens)
        grads = torch.autograd.grad(value, flat)
        out["loss"].append(value.item())
        with torch.no_grad():
            for p in flat:
                p.requires_grad_(False)
            norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
            scale = min(1.0, hp.grad_clip / (norm.item() + 1e-9)) if hp.grad_clip > 0 else 1.0
            lr = lr_at(hp, step)
            bc1, bc2 = 1 - hp.beta1 ** (step + 1), 1 - hp.beta2 ** (step + 1)
            for i, (p, g) in enumerate(zip(flat, grads)):
                g = g * scale
                if step == 0:
                    out["grad_norm"][names[i]] = g.norm().item()
                m[i].mul_(hp.beta1).add_((1 - hp.beta1) * g)
                v[i].mul_(hp.beta2).add_((1 - hp.beta2) * g.square())
                delta = (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + hp.eps) + hp.weight_decay * p
                p.sub_(lr * delta)
            del grads
    with torch.no_grad():
        for name, p, p0 in zip(names, flat, start):
            out["change_norm"][name] = (p - p0).norm().item()
    return out
