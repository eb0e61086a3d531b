"""The comparison that decides a serving cell's ``correct``.

Each checked request is given as the sequence its batch ran (the prompt
left-padded with token 0 to the batch's longest, as the port's batch
handler pads, with no mask), every token its batch row produced (``all``:
the batch's largest ask), the tokens the request asked for (``served``,
the first of them) and the logits the timed path produced for its row:
the prefill's at the last prompt position (``prefill``) and the last
decode step's (``last``). The reference runs once over the padded prompt
and the produced tokens (teacher-forced) and gives two numbers:

* the widest gap by which a served token's logit lies below the
  reference's best, over every served token: 0 where each is the
  reference's argmax, small where a near-tie went the other way;
* the largest difference between the program's logits and the
  reference's at those two positions, which holds the prefill and the
  decode steps' result to the reference whether or not a near-tie falls
  inside the sample;
* the median over the checked requests of that difference, each
  request's largest over its two positions: steady from seed to seed,
  where the largest swings with the one request whose sequence amplifies
  float32 rounding most.

The control reads the same positions of the same sequences with the
reference computed in TF32 in the program's place: the gap of the token
it puts first, and its logits' difference from the float32 reference's.
"""

from __future__ import annotations

import statistics

import torch

from . import models


def sequence(prompt: list[int], padded_len: int,
             produced: list[int]) -> tuple[list[int], list[int]]:
    """(tokens to run, positions whose logits predict ``produced``)."""
    pad = padded_len - len(prompt)
    tokens = [0] * pad + list(prompt) + list(produced[:-1])
    first = padded_len - 1
    return tokens, list(range(first, first + len(produced)))


def _logits(params: dict, cfg: dict, items: list[dict], device: torch.device, chunk: int):
    """Yields (item, the reference's logits at every produced position)."""
    for i in range(0, len(items), chunk):
        group = items[i:i + chunk]
        seqs = [sequence(it["prompt"], it["padded_len"], it["all"]) for it in group]
        longest = max(len(t) for t, _ in seqs)
        tokens = torch.zeros((len(seqs), longest), dtype=torch.long, device=device)
        for j, (t, _) in enumerate(seqs):
            tokens[j, :len(t)] = torch.tensor(t, dtype=torch.long, device=device)
        yield from zip(group, models.logits_at(params, cfg, tokens, [r for _, r in seqs]))


def _gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """Widest gap of the ``chosen`` tokens' logits below each row's best."""
    return (ref.max(1).values - ref.gather(1, chosen[:, None])[:, 0]).max().item()


def _error(ref: torch.Tensor, prefill: torch.Tensor | None, last: torch.Tensor | None) -> float:
    worst = 0.0
    for row, got in ((0, prefill), (ref.shape[0] - 1, last)):
        if got is not None:
            worst = max(worst, (got.to(ref.device).float() - ref[row]).abs().max().item())
    return worst


def served(params: dict, cfg: dict, items: list[dict], device: torch.device,
           chunk: int) -> dict:
    """The program's readings: ``max_logit_gap``, ``max_logit_error``,
    ``median_logit_error`` and the served tokens checked."""
    out = {"max_logit_gap": 0.0, "tokens": 0}
    errors = []
    with models.precision("float32"):
        for it, ref in _logits(params, cfg, items, device, chunk):
            n = len(it["served"])
            chosen = torch.tensor(it["served"], device=device)
            out["max_logit_gap"] = max(out["max_logit_gap"], _gap(ref[:n], chosen))
            errors.append(_error(ref, it["prefill"], it["last"]))
            out["tokens"] += n
    out["max_logit_error"] = max(errors, default=0.0)
    out["median_logit_error"] = statistics.median(errors) if errors else 0.0
    return out


def control(params: dict, cfg: dict, items: list[dict], device: torch.device,
            chunk: int) -> dict:
    """The control's readings of the same three numbers: the reference in
    TF32 in the program's place."""
    with models.precision("float32"):
        refs = [ref for _, ref in _logits(params, cfg, items, device, chunk)]
    out = {"max_logit_gap": 0.0}
    errors = []
    with models.precision("tf32"):
        for (it, low), ref in zip(_logits(params, cfg, items, device, chunk), refs):
            n = len(it["served"])
            out["max_logit_gap"] = max(out["max_logit_gap"], _gap(ref[:n], low[:n].argmax(1)))
            errors.append(_error(ref, low[0], low[-1]))
    out["max_logit_error"] = max(errors, default=0.0)
    out["median_logit_error"] = statistics.median(errors) if errors else 0.0
    return out
