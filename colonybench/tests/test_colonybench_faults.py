"""Whole runs of each cell at smoke size on the CPU (the broker, and for
serving the clients, in their own processes, the executor here), with the
timed path broken underneath: ``correct`` has to come out false for each
fault a cell can have, and true without one. The cells run on one chip,
so no exchange between chips can be left out."""

from __future__ import annotations

import time

import pytest
import torch

from colonybench import harness

from smoke_cells import smoke_cell

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SERVE = [c for c in CELLS if c.startswith("serve-")]
TRAIN = [c for c in CELLS if c.startswith("train.")]


def altered_token(ex):
    """One token of every batch changed where the engine produces it."""
    generate = ex.engine.generate

    def wrong(*args, **kwargs):
        out = generate(*args, **kwargs)
        out[0, 1] = (out[0, 1] + 1) % ex.engine.cfg.vocab_size
        return out

    ex.engine.generate = wrong


def state_unchanged(ex):
    """The decode step writes a copy of its cache, leaving the cache (the
    KV rows, the recurrent state) as the prefill left it."""
    from repro_torch.tree import map_leaves

    decode = ex.engine._decode
    ex.engine._decode = lambda p, tok, cache, pos: decode(p, tok, map_leaves(torch.clone, cache),
                                                         pos)


def half_batch(ex):
    """Only the first half of each batch is computed; the rest is filled
    from it."""
    generate = ex.engine.generate

    def half(tokens, *args, **kwargs):
        n = (tokens.shape[0] + 1) // 2
        out = generate(tokens[:n], *args, **kwargs)
        return out[[i % n for i in range(tokens.shape[0])]]

    ex.engine.generate = half


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", [None, altered_token, state_unchanged, half_batch],
                         ids=["sound", "altered_token", "state_unchanged", "half_batch"])
def test_fault_turns_correct_false(cell, fault):
    kw = smoke_cell(cell)
    result, notes = harness.run_cell(cell, 2**32 + 99, 2.0, False, t_start=time.perf_counter(),
                                     hooks=[fault] if fault else [], **kw)
    assert result["correct"] is (fault is None), notes
    assert result["attempted"] > 0 and list(result)[-1] == "checks"


def train_state_unchanged(mp):
    """The optimizer leaves the parameters and moments as they were."""
    from repro_torch.train import train_step

    mp.setattr(train_step, "opt_update", lambda params, grads, opt, step, tcfg: (params, opt))


def train_half_batch(mp):
    """The loss is the mean over the first half of each batch."""
    from repro_torch.train import train_step

    loss_fn = train_step.loss_fn
    mp.setattr(train_step, "loss_fn", lambda params, cfg, tcfg, batch: loss_fn(
        params, cfg, tcfg, {k: v[: v.shape[0] // 2] for k, v in batch.items()}))


def train_altered_token(mp):
    """One token of every batch changed where the step reads it."""
    from repro_torch.train import train_step

    loss_fn = train_step.loss_fn

    def altered(params, cfg, tcfg, batch):
        tokens = batch["tokens"].clone()
        tokens[0, 1] = (tokens[0, 1] + 1) % cfg.vocab_size
        return loss_fn(params, cfg, tcfg, dict(batch, tokens=tokens))

    mp.setattr(train_step, "loss_fn", altered)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [None, train_state_unchanged, train_half_batch,
                                   train_altered_token],
                         ids=["sound", "state_unchanged", "half_batch", "altered_token"])
def test_train_fault_turns_correct_false(cell, fault, monkeypatch):
    kw = smoke_cell(cell)
    if fault is not None:
        fault(monkeypatch)
    result, notes = harness.run_cell(cell, 2**32 + 98, 2.0, False, t_start=time.perf_counter(),
                                     **kw)
    assert result["correct"] is (fault is None), notes
    assert result["metrics"]["train_tokens_per_s"]["value"] > 0
