"""Serving engine: prefill + decode with sampling.

Port of the reference's ``serve/engine.py``. ``make_serve_step`` (decode
one token for the whole batch against the cache) and ``make_prefill`` are
the step functions the dry-run's decode and prefill cells trace.

Where the reference jits prefill, decode and sampling, the port runs the
prefill eagerly and decodes through one step over static buffers (the
token, a 0-dim position tensor, a cache shaped like the prefill's and the
gathered output), built once per batch size and cache layout. On a card
that step is captured once in a CUDA graph and replayed once per token,
so the decode loop does nothing on the host but launch the replays and
fetch the tokens at the end; on the CPU the same step runs directly on
the same buffers. Greedy decoding is ``argmax`` and matches the reference
token for token; with temperature > 0 tokens are drawn by Gumbel-max from
a ``torch.Generator`` seeded by ``seed``, which cannot reproduce
``jax.random.categorical``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..data.pipeline import to_device
from ..device import CAPTURE_LOCK, resolve_device
from ..kernels.launches import GraphLaunches
from ..models.model import decode_step, prefill
from ..tree import leaves, leaves_with_names, map_leaves

# Eager runs of a new step on the capture stream before its capture, as
# torch's CUDA graph documentation asks (lazy cuBLAS handles and workspaces).
WARMUP_STEPS = 3
# Decode keys an engine keeps, least recently used dropped first: each holds
# a whole max_len cache (and on a card a graph), and a batcher's batch size
# or a memory's length can take many values.
MAX_DECODE_KEYS = 4


def make_serve_step(cfg: ModelConfig):
    """(params, tokens (B, 1), cache, pos) -> (logits (B, 1, V), cache);
    ``pos`` a Python int or a 0-dim integer tensor. The cache is written
    in place and returned (ROADMAP C21)."""

    def serve_step(params, tokens, cache, pos):
        return decode_step(params, cfg, tokens, cache, pos)

    return serve_step


def make_prefill(cfg: ModelConfig, max_len: int | None = None):
    """(params, batch) -> (last-position logits (B, 1, V), the decode cache
    grown to ``max_len``)."""

    def prefill_fn(params, batch):
        return prefill(params, cfg, batch, max_len=max_len)

    return prefill_fn


def sample_token(logits: torch.Tensor, temperature: float | torch.Tensor,
                 generator: torch.Generator | None) -> torch.Tensor:
    """logits: (B, 1, V) -> (B, 1) int64: ``argmax`` without a generator,
    else a draw from softmax(logits / temperature) by Gumbel-max,
    ``argmax(logits / T - log(-log U))`` with U uniform from ``generator``
    (no host sync, so a CUDA graph can hold it; ``temperature`` a float or
    a 0-dim tensor)."""
    last = logits[:, -1]
    if generator is None:
        return last.argmax(dim=-1, keepdim=True)
    u = torch.rand(last.shape, generator=generator, device=last.device)
    return (last.float() / temperature - torch.log(-torch.log(u))).argmax(dim=-1, keepdim=True)


class DecodeStep:
    """One decode key's static buffers and the step over them.

    ``tok`` (B, 1), the 0-dim int64 ``pos``, ``cache`` (zeros shaped like
    the prefill cache it was built from), ``out`` (B, max_len) holding each
    token at its position, and for sampling a 0-dim ``temperature`` and a
    ``generator``. ``body`` decodes ``tok`` at ``pos``, samples the next
    token into ``tok``, advances ``pos`` and writes the token to ``out``;
    ``logits`` is its last output (on a card, the graph's output tensor).
    ``graph`` is the captured body on a card, None on the CPU; each replay
    adds the kernel launches the capture recorded (``GraphLaunches``)."""

    def __init__(self, decode, params: Any, cache: dict, batch: int, max_len: int,
                 sampled: bool, device: torch.device):
        self._decode, self._params = decode, params
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.out = torch.zeros((batch, max_len), dtype=torch.long, device=device)
        self.cache = map_leaves(torch.zeros_like, cache)
        self.temperature = torch.ones((), device=device) if sampled else None
        self.generator = torch.Generator(device=device) if sampled else None
        self.logits: torch.Tensor | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self._launches = GraphLaunches()

    def body(self) -> None:
        logits, _ = self._decode(self._params, self.tok, self.cache, self.pos)
        self.tok.copy_(sample_token(logits, self.temperature, self.generator))
        self.pos.add_(1)
        self.out.index_copy_(1, self.pos.reshape(1), self.tok)
        self.logits = logits

    def capture(self, pool) -> None:
        """Warm the body up on the capture stream, then capture it there
        into a graph drawing on ``pool``. Another thread's CUDA work does
        not break the capture (``thread_local``); a failure raises."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        capturing = torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local")
        stream = capturing.capture_stream
        with CAPTURE_LOCK:
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_STEPS):
                    self.pos.zero_()  # any cache row will do, as long as it exists
                    self.body()
            torch.cuda.current_stream().wait_stream(stream)
            with self._launches.capturing(), capturing:
                self.body()
        self.graph = graph

    def load(self, cache: dict, tok: torch.Tensor, pos: int) -> None:
        """Every leaf of a prefill cache copied whole into the static one
        (no row of an earlier batch survives); the first token at ``pos``."""
        for dst, src in zip(leaves(self.cache), leaves(cache), strict=True):
            dst.copy_(src)
        self.tok.copy_(tok)
        self.pos.fill_(pos)
        self.out[:, pos : pos + 1].copy_(tok)

    def run(self, steps: int) -> None:
        """``steps`` decode steps: graph replays on a card, the body on the
        CPU. Nothing here waits for the device."""
        step = self.body if self.graph is None else self.graph.replay
        for _ in range(steps):
            step()
        if self.graph is not None:
            self._launches.replayed(steps)


class ServeEngine:
    """Host-side generation loop: an eager prefill, then decode steps over
    static buffers (``DecodeStep``), one per key in ``steps``.

    ``params`` is moved to ``device`` (a no-op when it already lives there).
    A key is the batch size, whether tokens are sampled, and the paths,
    shapes and dtypes of the prefill cache's leaves; its buffers (and on a
    card its graph, in one memory pool shared by the engine's keys) live
    until ``MAX_DECODE_KEYS`` more recently used keys push them out. One
    batch at a time holds them. A key's step reads the ``params`` it was
    built with, so assigning ``params`` drops every key (changing their
    values in place is seen by every step).
    """

    def __init__(self, cfg: ModelConfig, params: Any, max_len: int = 256,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = max_len
        self._prefill = make_prefill(cfg, max_len)
        self._decode = make_serve_step(cfg)
        self.stats = {"requests": 0, "tokens": 0, "batches": 0}
        self.steps: OrderedDict[tuple, DecodeStep] = OrderedDict()
        self._lock = threading.Lock()
        self._pool = None
        self.params = params

    @property
    def params(self) -> Any:
        """The weights. Assigned, they are moved to the engine's device and
        every decode key's buffers and graph go with the old ones."""
        return self._params

    @params.setter
    def params(self, params: Any) -> None:
        with self._lock:
            self._params = map_leaves(lambda t: t.to(self.device), params)
            self.steps.clear()

    def _step_for(self, cache: dict, batch: int, sampled: bool) -> DecodeStep:
        key = (batch, sampled,
               tuple((name, tuple(t.shape), t.dtype) for name, t in leaves_with_names(cache)))
        step = self.steps.get(key)
        if step is not None:
            self.steps.move_to_end(key)
        else:
            if len(self.steps) == MAX_DECODE_KEYS:
                self.steps.popitem(last=False)
            step = DecodeStep(self._decode, self.params, cache, batch, self.max_len, sampled,
                              self.device)
            if self.device.type == "cuda":
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                step.capture(self._pool)
            self.steps[key] = step
        return step

    @torch.inference_mode()
    def generate(
        self,
        tokens: np.ndarray,  # (B, S) right-aligned prompts
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        seed: int = 0,
        extras: dict | None = None,
    ) -> np.ndarray:
        """``extras`` holds the memory a cross-attending model reads, one row
        per prompt (``image_embeds`` for llama-3.2-vision, ``src_frames``
        for seamless; arrays or tensors), moved to the engine's device; the
        model casts it to the compute dtype. Such a model without it raises
        ``ValueError`` naming the key."""
        b, s = tokens.shape
        assert s + max_new_tokens <= self.max_len, "increase max_len"
        batch = {"tokens": torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)}
        for key, val in (extras or {}).items():
            batch[key] = (val.to(self.device) if isinstance(val, torch.Tensor)
                          else to_device({key: val}, self.device)[key])
        with self._lock:
            logits, cache = self._prefill(self.params, batch)
            step = self._step_for(cache, b, temperature > 0.0)
            if step.generator is not None:
                step.generator.manual_seed(seed)
                step.temperature.fill_(temperature)
            step.load(cache, sample_token(logits, step.temperature, step.generator), s)
            del logits, cache
            step.run(max_new_tokens - 1)
            out = step.out[:, s : s + max_new_tokens].to(torch.int32).cpu().numpy()
            self.stats["requests"] += b
            self.stats["tokens"] += b * max_new_tokens
            self.stats["batches"] += 1
        return out
