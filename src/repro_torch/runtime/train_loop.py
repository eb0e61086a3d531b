"""Training, evaluation, data and serving hand-off handlers of the port.

The bodies of the reference's executor handlers
(``runtime/jax_executor.py``: ``TrainerExecutor.train`` and
``.evaluate``, ``DataExecutor.prepare_data`` and the checkpoint restore
of ``ServeExecutor``), with the same kwargs, defaults and return values,
as plain functions of a CFS-like store and a colony name. A torch
executor wraps them unchanged once the broker side is ported (ROADMAP
A8).

Every handler builds the smoke variant in float32 unless told otherwise,
as the reference's ``_smoke_cfg`` does. ``train`` resumes from the run's
``latest.json`` checkpoint, so a call after a crash (``die_at_step``)
loses at most ``checkpoint_every`` steps. The store is anything with
``upload_bytes``, ``download_bytes``, ``client.create_snapshot`` and
``prvkey``: the reference's ``CFSClient``, or ``runtime.store.MemoryStore``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs import TrainConfig, get_config
from ..configs.base import ModelConfig
from ..data.pipeline import SyntheticTokens, to_device
from ..device import resolve_device
from ..models.spec import init_params, model_spec
from ..serve.engine import ServeEngine
from ..train.checkpoint import CheckpointManager
from ..train.train_step import init_state, make_eval_step, make_train_step, split_microbatches


class SimulatedCrash(Exception):
    """Raised inside a handler to emulate sudden executor death: the
    process is not closed or failed; the broker's failsafe re-queues it."""

    simulate_crash = True  # an executor re-raises instead of closing


def _smoke_cfg(kwargs: dict) -> ModelConfig:
    cfg = get_config(kwargs["arch"], kwargs.get("variant", "smoke"))
    # float32 numerics, as the reference's handlers use
    return cfg.copy(param_dtype="float32", compute_dtype="float32",
                    use_pallas=bool(kwargs.get("use_pallas", False)))


def _init_state(cfg: ModelConfig, tcfg: TrainConfig, device: torch.device) -> dict:
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    return init_state(init_params(model_spec(cfg), gen, torch.float32, device), tcfg)


# ---------------------------------------------------------------------- data
def prepare_data(store: Any, colony: str, **kw: Any) -> list[Any]:
    """'Edge' ingest: synthesize token shards into CFS and snapshot them."""
    shards = int(kw.get("shards", 2))
    tokens_per_shard = int(kw.get("tokens_per_shard", 1024))
    label = kw.get("label", "/datasets/synth")
    rng = np.random.default_rng(int(kw.get("seed", 0)))
    uploaded = []
    for i in range(shards):
        toks = rng.integers(0, int(kw.get("vocab", 256)), tokens_per_shard, dtype=np.int32)
        meta = store.upload_bytes(colony, label, f"shard-{i:04d}.bin", toks.tobytes())
        uploaded.append(meta["fileid"])
    snap = store.client.create_snapshot(colony, label, kw.get("snapshot_name", "dataset-v1"),
                                        store.prvkey)
    return [{"snapshotid": snap["snapshotid"], "files": len(uploaded)}]


# --------------------------------------------------------------------- train
def train_run(store: Any, colony: str, *, device: str | torch.device = "cuda",
              die_at_step: int | None = None, **kw: Any) -> tuple[list[Any], dict]:
    """``train``, also returning the final train state (in memory)."""
    cfg = _smoke_cfg(kw)
    dev = resolve_device(device)
    steps = int(kw.get("steps", 10))
    batch_size = int(kw.get("batch", 4))
    seq_len = int(kw.get("seq_len", 64))
    run = kw.get("run", "run0")
    tcfg = TrainConfig(
        optimizer=kw.get("optimizer", "adamw"),
        learning_rate=float(kw.get("learning_rate", 3e-4)),
        warmup_steps=int(kw.get("warmup_steps", 10)),
        total_steps=steps,
        microbatches=int(kw.get("microbatches", 1)),
        checkpoint_every=int(kw.get("checkpoint_every", 5)),
        seed=int(kw.get("seed", 0)),
    )
    ckpt = CheckpointManager(store, colony, run=run)
    data = SyntheticTokens(cfg, batch_size, seq_len, seed=tcfg.seed)

    state = _init_state(cfg, tcfg, dev)
    start = 0
    restored = ckpt.restore_latest(state)
    if restored is not None:
        state, start = restored
        start += 1  # resume after the checkpointed step
    step_fn = make_train_step(cfg, tcfg)

    last_metrics: dict = {}
    for step in range(start, steps):
        if die_at_step is not None and step == die_at_step:
            raise SimulatedCrash(f"chaos at step {step}")
        host = data.batch_at(step)
        if tcfg.microbatches > 1:  # the step takes the batch pre-split
            host = split_microbatches(host, tcfg.microbatches)
        state, metrics = step_fn(state, to_device(host, dev))
        last_metrics = {k: float(v) for k, v in metrics.items()}
        if (step + 1) % tcfg.checkpoint_every == 0 or step == steps - 1:
            ckpt.save(state, step, async_=False)
    return [{"final_step": steps - 1, "metrics": last_metrics, "run": run}], state


def train(store: Any, colony: str, *, device: str | torch.device = "cuda",
          die_at_step: int | None = None, **kw: Any) -> list[Any]:
    """A checkpointed training loop from the run's latest checkpoint (or a
    fresh init from ``seed``). ``die_at_step`` raises ``SimulatedCrash``
    before that step runs."""
    return train_run(store, colony, device=device, die_at_step=die_at_step, **kw)[0]


# ------------------------------------------------------------------ evaluate
def evaluate(store: Any, colony: str, *, device: str | torch.device = "cuda",
             **kw: Any) -> list[Any]:
    """Mean CE over ``eval_batches`` held-out batches (seed 9999) from the
    run's latest checkpoint."""
    cfg = _smoke_cfg(kw)
    dev = resolve_device(device)
    run = kw.get("run", "run0")
    batch_size = int(kw.get("batch", 4))
    seq_len = int(kw.get("seq_len", 64))
    batches = int(kw.get("eval_batches", 2))
    # the reference restores into an AdamW state whatever the run trained
    # with; the optimizer kwarg lets an Adafactor run's checkpoint restore
    tcfg = TrainConfig(optimizer=kw.get("optimizer", "adamw"), seed=int(kw.get("seed", 0)))
    ckpt = CheckpointManager(store, colony, run=run)
    restored = ckpt.restore_latest(_init_state(cfg, tcfg, dev))
    if restored is None:
        raise RuntimeError(f"no checkpoint for run {run}")
    state, step = restored
    eval_fn = make_eval_step(cfg, tcfg)
    data = SyntheticTokens(cfg, batch_size, seq_len, seed=9999)
    ces = [float(eval_fn(state["params"], to_device(data.batch_at(i), dev))["ce"])
           for i in range(batches)]
    return [{"step": step, "eval_ce": float(np.mean(ces)), "run": run}]


# ----------------------------------------------------------- serve hand-off
def serve_engine(store: Any, colony: str, *, arch: str = "stablelm-3b", max_len: int = 128,
                 run: str | None = None, device: str | torch.device = "cuda") -> ServeEngine:
    """The reference's ``ServeExecutor`` set-up: a ``ServeEngine`` on the
    smoke config, serving the run's latest checkpoint when ``run`` is given
    and one exists (the continuum's train→serve hand-off), else the fresh
    init of seed 0."""
    cfg = _smoke_cfg({"arch": arch})
    dev = resolve_device(device)
    state = _init_state(cfg, TrainConfig(), dev)
    if run is not None:
        restored = CheckpointManager(store, colony, run=run).restore_latest(state)
        if restored is not None:
            state = restored[0]
    return ServeEngine(cfg, state["params"], max_len=max_len, device=dev)
