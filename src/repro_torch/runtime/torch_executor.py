"""Torch executors — the meta-description → executable translation layer.

Port of the reference's ``runtime/jax_executor.py``. The paper's
executors translate function specifications into Kubernetes deployments
or Slurm scripts; these translate them into PyTorch programs on the
executor's device. A ``train`` spec becomes a checkpointed training loop;
an ``evaluate`` spec becomes an eval sweep from the latest CFS
checkpoint; ``generate_batch`` (fired by the dynamic-batching generator)
becomes one batched inference call. The handlers' bodies are
``runtime.train_loop``'s, with the reference's funcnames, kwargs,
defaults and return values.

The device belongs to the executor, not to the spec: a spec stays a
framework-neutral meta-description, and one colony can hold JAX and torch
executors side by side (each with its own executortype). An executor
asked for ``"cuda"`` without a card raises when it is constructed.

Fault tolerance is the broker's: each handler resumes from the latest
CFS checkpoint, so a ``maxexectime`` re-assignment after an executor
crash loses at most ``checkpoint_every`` steps.
"""

from __future__ import annotations

import os
import threading
from typing import Any

import torch

from .. import device as _device
from .. import trace
from ..core.client import Colonies
from ..core.errors import ValidationError
from ..core.executor import ExecutorBase, ProcessContext
from ..core.fs import CFSClient, Storage
from ..core.retry import RetryPolicy
from ..serve.batcher import make_batch_handler
from . import train_loop
from .chaos import SimulatedCrash

# Default blob-plane retry: generous enough to ride out one storage
# shard dying mid-operation (a sharded store already tolerates R−1 shard
# failures per call; this covers the window where ALL of a key's
# replicas are briefly unreachable).
BLOB_RETRY = RetryPolicy(base_s=0.01, cap_s=0.25, deadline_s=10.0, budget=6)


class TorchExecutorBase(ExecutorBase):
    """ExecutorBase + a device + CFS access + crash simulation support.

    Implements the paper's fs sync directives (§3.4.5, Listing 2): before
    a handler runs, every ``fs.snapshots`` entry is materialized and
    every ``fs.dirs`` entry synced down into the process workdir; after
    it succeeds, ``fs.dirs`` entries with ``upload`` sync back up. All
    blob traffic is retry-backed (see BLOB_RETRY / CFSClient).

    Every thread that runs a handler first runs float32 ``exp`` on each
    thread of its own OpenMP team (``device.warm_cpu_exp``, ROADMAP C11):
    the worker thread of ``start()`` is not the thread that imported the
    package, and its team's first MKL ``exp`` can come back inexact.
    """

    def __init__(self, client: Colonies, colonyname: str, executorname: str,
                 executortype: str, storage: Storage, colony_prvkey: str | None = None,
                 blob_retry: RetryPolicy | None = BLOB_RETRY,
                 device: str | torch.device = "cuda", **kw: Any) -> None:
        self.device = _device.resolve_device(device)  # no card: raise before registering
        self._warm = threading.local()
        super().__init__(client, colonyname, executorname, executortype,
                         colony_prvkey=colony_prvkey, **kw)
        self.storage = storage
        self.cfs = CFSClient(client, storage, self.prvkey, retry=blob_retry)

    def _execute(self, process) -> None:
        if not getattr(self._warm, "done", False):
            _device.warm_cpu_exp()
            self._warm.done = True
        try:
            with trace.span("executor.execute", trace_id=process.processid):
                super()._execute(process)
        except SimulatedCrash:
            self.failed += 1  # vanish without closing — failsafe must recover

    # ------------------------------------------------- fs sync directives
    def _mount_dir(self, ctx: ProcessContext, directive_dir: str) -> str:
        """Resolve a directive's ``dir`` inside the process workdir.

        ``dir`` is relative to ``fs.mount`` (absolute paths are
        re-anchored by stripping the mount prefix); the result must stay
        inside the workdir — directives are part of the untrusted spec.
        """
        fs = ctx.process.spec.fs
        d = directive_dir or ""
        if fs.mount and d.startswith(fs.mount):
            d = d[len(fs.mount):]
        d = d.lstrip("/")
        base = ctx.workdir or "."
        for comp in d.split("/"):
            if comp in (".", "..") or "\\" in comp:
                raise ValidationError(f"unsafe fs directive dir {directive_dir!r}")
        dest = os.path.join(base, d) if d else base
        os.makedirs(dest, exist_ok=True)
        return dest

    def _sync_before(self, ctx: ProcessContext) -> None:
        fs = ctx.process.spec.fs
        for snap in fs.snapshots:
            self.cfs.materialize_snapshot(
                self.colonyname, snap.snapshotid, self._mount_dir(ctx, snap.dir)
            )
        for d in fs.dirs:
            self.cfs.sync_down(self.colonyname, d.label, self._mount_dir(ctx, d.dir))

    def _sync_after(self, ctx: ProcessContext) -> None:
        for d in ctx.process.spec.fs.dirs:
            if d.upload:
                self.cfs.sync_up(
                    self.colonyname, d.label, self._mount_dir(ctx, d.dir)
                )


class TrainerExecutor(TorchExecutorBase):
    """Handles ``train`` and ``evaluate`` function specs.

    ``die_at_step`` crashes the first attempt that reaches that step
    (``SimulatedCrash``: the process is neither closed nor failed) and is
    then cleared, so a re-assigned attempt survives."""

    def __init__(self, *args: Any, die_at_step: int | None = None, **kw: Any) -> None:
        super().__init__(*args, **kw)
        self.die_at_step = die_at_step
        self.register_function("train", self.train)
        self.register_function("evaluate", self.evaluate)

    def train(self, ctx: ProcessContext, **kw: Any) -> list[Any]:
        try:
            return train_loop.train(self.cfs, self.colonyname, device=self.device,
                                    die_at_step=self.die_at_step, **kw)
        except SimulatedCrash:
            self.die_at_step = None  # a respawned clone must survive
            raise

    def evaluate(self, ctx: ProcessContext, **kw: Any) -> list[Any]:
        return train_loop.evaluate(self.cfs, self.colonyname, device=self.device, **kw)


class ServeExecutor(TorchExecutorBase):
    """Hosts a ServeEngine; handles generator-fired ``generate_batch``.

    ``variant`` picks the config the engine serves (the reference serves
    ``"smoke"`` only); weights are float32 either way, and ``run`` serves
    that run's latest CFS checkpoint (the continuum's hand-off)."""

    def __init__(self, *args: Any, arch: str = "stablelm-3b", max_len: int = 128,
                 run: str | None = None, variant: str = "smoke", **kw: Any) -> None:
        super().__init__(*args, **kw)
        self.engine = train_loop.serve_engine(self.cfs, self.colonyname, arch=arch,
                                              variant=variant, max_len=max_len, run=run,
                                              device=self.device)
        self.register_function(
            "generate_batch", make_batch_handler(self.engine, self.cfs, self.colonyname)
        )


class DataExecutor(TorchExecutorBase):
    """'Edge' executor: ingests (synthesizes) raw data into CFS."""

    def __init__(self, *args: Any, **kw: Any) -> None:
        super().__init__(*args, **kw)
        self.register_function("prepare_data", self.prepare_data)

    def prepare_data(self, ctx: ProcessContext, **kw: Any) -> list[Any]:
        return train_loop.prepare_data(self.cfs, self.colonyname, **kw)
