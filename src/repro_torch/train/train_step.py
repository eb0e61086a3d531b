"""train_step: causal-LM loss and microbatched gradient accumulation.

Port of the reference's ``train/train_step.py``. The step is a function
(state, batch) -> (state, metrics), with the reference's state
``{"step": int32 0-d, "params": ..., "opt": ...}``. With ``microbatches``
k > 1 the batch arrives pre-split as (k, B/k, ...) and float32 gradients
accumulate as g/k in microbatch order. With experts the loss adds the
weighted load-balance and router z losses, reported as ``moe_lb`` and
``moe_z``; with multi-token prediction (deepseek) it adds
``mtp_loss_weight`` times the MTP block's CE on token t+2, reported as
``mtp_ce``.

``make_train_step`` and ``make_eval_step`` are the bodies, which the
dry-run traces. ``TrainStep`` and ``EvalStep`` are what the reference's
``jax.jit`` of them is to its executor: each runs its body over static
buffers (the batch, the state's own tensors, the metrics), and on a card
captures it once in a CUDA graph after ``WARMUP_STEPS`` real steps and
replays it for every later step. On the CPU the same body runs eagerly on
the same buffers. There is no switch and no eager fallback on a card.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig, TrainConfig
from ..data.pipeline import copy_into, to_device
from ..device import CAPTURE_LOCK
from ..kernels.launches import GraphLaunches
from ..models.model import forward, mtp_logits
from ..models.moe import moe_aux_loss
from ..tree import leaves, map_leaves, rebuild
from .optimizer import clip_by_global_norm, global_norm, lr_schedule, opt_init, opt_update

# Real steps run eagerly on the capture stream before a train or eval step
# is captured. One is enough (tests/test_torch_train_graph.py, on a card): it
# makes what a capture must not, cuBLAS's handle and workspace for the capture
# stream on the calling thread and on the autograd engine's device thread
# (which runs the backward and the remat recomputation), that thread itself,
# and the kernels' build and load. A train step's warm-up moves the
# parameters and moments, so it is one of the run's own steps, not a
# throwaway.
WARMUP_STEPS = 1


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None):
    """Mean next-token CE in float32. logits: (B,S,V); targets: (B,S) integer."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # a dry-run's vocab-sharded logits: the masked sum, whose shards
        # reduce with one all-reduce (DTensor's gather along a sharded dim
        # leaves a mask its reductions cannot apply); the same values
        hit = torch.arange(logits.shape[-1], device=logits.device) == targets[..., None]
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean(), nll.numel()
    denom = torch.clamp(mask.sum(), min=1)
    return (nll * mask).sum() / denom, denom


def loss_fn(params: Any, cfg: ModelConfig, tcfg: TrainConfig, batch: dict):
    tokens = batch["tokens"]
    want_hidden = cfg.mtp_depth > 0
    out = forward(params, cfg, batch, return_hidden=want_hidden)
    logits, aux = out[0], out[1]
    ce, _ = cross_entropy(logits[:, :-1], tokens[:, 1:])
    loss = ce
    metrics = {"ce": ce}
    if cfg.moe.num_experts > 0:
        loss = loss + moe_aux_loss(aux, cfg)
        metrics["moe_lb"] = aux["lb_loss"]
        metrics["moe_z"] = aux["z_loss"]
    if want_hidden:
        # MTP: logits at position t predict token t+2
        mlogits = mtp_logits(params, cfg, out[2], tokens)  # (B, S-1, V)
        mtp_ce, _ = cross_entropy(mlogits[:, :-1], tokens[:, 2:])
        loss = loss + tcfg.mtp_loss_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def init_state(params: Any, tcfg: TrainConfig) -> dict:
    device = leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "params": params,
        "opt": opt_init(params, tcfg),
    }


def split_microbatches(batch: dict, k: int) -> dict:
    """(B, ...) numpy leaves -> (k, B/k, ...), the layout ``train_step``
    takes when ``microbatches`` is k > 1."""
    return {key: np.asarray(v).reshape(k, -1, *np.shape(v)[1:]) for key, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    microbatch_indices: Callable[[int], Iterable[int]] = range):
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    float32 0-d tensors. The new parameters and optimizer state are written
    into the given state's tensors (as ``donate_argnums`` lets XLA do), so
    a step holds one copy of them. With k > 1 microbatches the step runs
    the microbatches ``microbatch_indices(k)`` yields (all k by default; the
    dry-run traces the first alone and counts it k times)."""

    def grads_of(params: Any, batch: dict) -> tuple[list[torch.Tensor], dict]:
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        flat = leaves(live)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, cfg, tcfg, batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        k = tcfg.microbatches
        if k > 1:
            if any(v.shape[0] != k for v in batch.values()):
                raise ValueError(f"microbatches={k}: batch leaves must arrive pre-split as "
                                 f"(k, B/k, ...) (split_microbatches)")
            flat = leaves(params)
            # zeros_like keeps a sharded parameter's placement in a dry-run
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            zero = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            metrics = {key: zero for key in _metric_keys(cfg)}
            for i in microbatch_indices(k):
                g, m = grads_of(params, {key: v[i] for key, v in batch.items()})
                for acc, gg in zip(grads, g):
                    acc.add_(gg.to(torch.float32) / k)
                del g
                metrics = {key: metrics[key] + m[key] / k for key in metrics}
        else:
            grads, metrics = grads_of(params, batch)

        with torch.no_grad():
            gtree = rebuild(params, grads)
            del grads
            if tcfg.grad_clip > 0:
                gtree, gnorm = clip_by_global_norm(gtree, tcfg.grad_clip)
            else:
                gnorm = global_norm(gtree)
            new_params, new_opt = opt_update(params, gtree, state["opt"], state["step"], tcfg)
            del gtree
            new_state = {"step": state["step"] + 1, "params": new_params, "opt": new_opt}
            metrics = dict(metrics)
            metrics["grad_norm"] = gnorm
            metrics["lr"] = lr_schedule(tcfg, state["step"])
        return new_state, metrics

    return train_step


def _metric_keys(cfg: ModelConfig) -> list[str]:
    keys = ["ce", "loss"]
    if cfg.moe.num_experts > 0:
        keys += ["moe_lb", "moe_z"]
    if cfg.mtp_depth > 0:
        keys += ["mtp_ce"]
    return keys


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig):
    @torch.no_grad()
    def eval_step(params: Any, batch: dict) -> dict:
        _, metrics = loss_fn(params, cfg, tcfg, batch)
        return metrics

    return eval_step


class _GraphStep:
    """A step's static batch and metrics, and the step over them.

    The first call copies its batch to the device, and those tensors are
    the static batch; every later call copies its batch into them (the same
    keys, shapes and dtypes, else ``ValueError``). On a card the first
    ``WARMUP_STEPS`` calls run the body eagerly on torch's capture stream,
    the next one captures it there in a CUDA graph of its own pool
    (``thread_local``, so another thread's work on the card does not break
    it; a failed capture raises) and replays it, and every later call
    replays it. A capture executes nothing, and ``torch.cuda.graph`` empties
    the allocator's cache on entry, so the warm-up's cached blocks go back
    to the card before the graph's pool is drawn. Each replay adds the
    kernel launches the capture recorded (``GraphLaunches``). On the CPU
    every call runs the body. ``metrics`` is the last call's output: on a
    card, from the capture on, the graph's output tensors, which the next
    call overwrites. ``close`` gives the graph, its pool and the static
    buffers back."""

    def __init__(self, device: torch.device):
        self.device = device
        self.batch: dict | None = None
        self.metrics: dict = {}
        self.calls = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self._launches = GraphLaunches()
        self._capturing = None
        if device.type == "cuda":
            with torch.cuda.device(device):
                self._capturing = torch.cuda.graph(torch.cuda.CUDAGraph(),
                                                   capture_error_mode="thread_local")

    def _body(self) -> dict:
        raise NotImplementedError

    def __call__(self, batch: dict) -> dict:
        if self.batch is None:
            self.batch = to_device(batch, self.device)
        else:
            copy_into(self.batch, batch)
        if self._capturing is None:
            self.metrics = self._body()
        elif self.graph is None and self.calls < WARMUP_STEPS:
            self._warm_up()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self._launches.replayed()
        self.calls += 1
        return self.metrics

    def _warm_up(self) -> None:
        """The body run eagerly on the capture stream, where the capture
        will find what it made."""
        stream = self._capturing.capture_stream
        current = torch.cuda.current_stream(self.device)
        with CAPTURE_LOCK:
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self.metrics = self._body()
            current.wait_stream(stream)

    def _capture(self) -> None:
        self.metrics = {}  # the warm-up's outputs, freed before the cache is emptied
        with CAPTURE_LOCK, self._launches.capturing(), self._capturing:
            self.metrics = self._body()
        self.graph = self._capturing.cuda_graph

    def close(self) -> None:
        """Drops the graph, its pool, the static batch and the metrics (a
        train step's state is the caller's), and on a card empties the
        allocator's cache so the pool goes back to the card."""
        self.metrics, self.batch, self.graph, self._capturing = {}, None, None, None
        if self.device.type == "cuda":
            with CAPTURE_LOCK:
                torch.cuda.empty_cache()


class TrainStep(_GraphStep):
    """The port's ``jax.jit(make_train_step(cfg, tcfg))``: ``step(batch)``
    takes a host batch in the layout the body takes ((k, B/k, ...) leaves
    with ``microbatches`` k > 1, ``split_microbatches``), runs one train
    step of ``state`` and returns its metrics (float32 0-d tensors).

    ``state`` is the caller's ``init_state`` dict, and it stays the same
    tensors: the body writes parameters and moments in place, and the step
    counter is advanced in place, so after any number of steps a checkpoint
    save reads them. The learning rate and the gradient norm are computed
    inside the step. The first ``WARMUP_STEPS`` steps run eagerly (a run
    with no more steps than that never captures); on a card the graph holds
    the microbatch loop, remat, ``torch.autograd.grad`` with the backward
    that the autograd engine runs on its own thread, clipping and the
    optimizer's update."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, state: dict):
        super().__init__(leaves(state["params"])[0].device)
        self.state = state
        self._step = make_train_step(cfg, tcfg)

    def _body(self) -> dict:
        new_state, metrics = self._step(self.state, self.batch)
        self.state["step"].copy_(new_state["step"])
        return metrics


class EvalStep(_GraphStep):
    """The port's ``jax.jit(make_eval_step(cfg, tcfg))`` on fixed
    ``params``: ``step(batch)`` returns the metrics of a host batch. The
    first ``WARMUP_STEPS`` batches run eagerly; on a card the next one is
    captured and every later one replays it."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, params: Any):
        super().__init__(leaves(params)[0].device)
        self.params = params
        self._eval = make_eval_step(cfg, tcfg)

    def _body(self) -> dict:
        return self._eval(self.params, self.batch)
