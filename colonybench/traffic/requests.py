"""Requests of a serving mix, drawn from the seed (numpy only: the client
process imports this without torch).

Every wave of a closed loop of N clients holds one request of each
client. Its prompt and output lengths are the N quantile points
(i + 1/2) / N of the mix's clipped lognormals, so every wave, under every
seed, has the same lengths; the seed deals them out among the clients
(one permutation for prompts, another for outputs) and draws the prompt
tokens uniformly from the vocabulary. A run then differs from another
only in which client asks what, and in the tokens.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def lengths(dist: dict, n: int) -> list[int]:
    """The n quantile points of a clipped lognormal (median, sigma, min, max)."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    inv = NormalDist().inv_cdf
    out = []
    for i in range(n):
        x = dist["median"] * math.exp(dist["sigma"] * inv((i + 0.5) / n))
        out.append(int(round(min(max(x, dist["min"]), dist["max"]))))
    return out


def wave(mix: dict, seed: int, index: int, vocab: int) -> list[dict]:
    """Wave ``index``: one request a client, {"prompt", "max_new_tokens"}."""
    n = mix["clients"]
    rng = np.random.default_rng([seed, index])
    prompts = rng.permutation(lengths(mix["prompt"], n))
    outputs = rng.permutation(lengths(mix["output"], n))
    return [{"prompt": rng.integers(0, vocab, int(p)).tolist(), "max_new_tokens": int(o)}
            for p, o in zip(prompts, outputs)]
