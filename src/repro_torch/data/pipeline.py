"""Deterministic synthetic data pipeline with background prefetch.

Port of the reference's ``data/pipeline.py``. Batches come from a
counter-keyed numpy PRNG, so every step's batch is reproducible across
restarts and byte-identical to the reference's. A background thread keeps
a small prefetch queue full. ``to_device`` stands in for the reference's
``device_put_batch``; ``copy_into`` writes a batch into the static tensors
of a captured step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig


def _np_dtype(name: str) -> np.dtype:
    """numpy has no bfloat16 of its own; ``ml_dtypes`` (the type the
    reference's numpy batches carry) supplies it."""
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


class SyntheticTokens:
    """Markov-ish synthetic token stream (not uniform noise: CE can drop)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        v = self.cfg.vocab_size
        b, s = self.batch, self.seq_len
        # structured stream: tok_{t+1} = (a*tok_t + c + noise) % V — learnable
        a = 31
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = (rng.random((b, s)) < 0.1) * rng.integers(1, v, (b, s))
        for t in range(1, s):
            toks[:, t] = (a * toks[:, t - 1] + 7 + noise[:, t]) % v
        out = {"tokens": toks}
        if self.cfg.cross_attn_every > 0:
            out["image_embeds"] = rng.standard_normal(
                (b, self.cfg.num_patches, self.cfg.vision_embed_dim), np.float32
            ).astype(_np_dtype(self.cfg.compute_dtype))
        if self.cfg.is_encdec:
            src = min(self.cfg.max_src_len, s)
            out["src_frames"] = rng.standard_normal(
                (b, src, self.cfg.audio_embed_dim), np.float32
            ).astype(_np_dtype(self.cfg.compute_dtype))
        return out


class Prefetcher:
    """Background-thread prefetch queue over a step-indexed source."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0, depth: int = 2):
        self.source = source
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.queue.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while not self._stop.is_set():
            yield self.queue.get()

    def next(self) -> tuple[int, dict]:
        return self.queue.get()

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # same bits, reinterpreted
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def to_device(batch: dict, device: str | torch.device) -> dict:
    """Host batch -> tensors on ``device``. To a card the host copy is
    pinned and sent with ``non_blocking=True``; on the CPU it is a plain
    copy (never a view of the numpy batch)."""
    dev = torch.device(device)
    out = {}
    for key, arr in batch.items():
        host = _host_tensor(np.asarray(arr))
        if dev.type == "cuda":
            out[key] = host.pin_memory().to(dev, non_blocking=True)
        else:
            out[key] = host.clone()
    return out


def copy_into(static: dict, batch: dict) -> None:
    """Host batch -> the tensors ``static`` (the same keys, shapes and
    dtypes), in place, as ``to_device`` sends it: to a card each leaf is
    pinned afresh and sent with ``non_blocking=True`` (torch's cache of
    pinned blocks hands a block out again only after the copy reading it
    has run), so nothing here waits for the device."""
    if set(static) != set(batch):
        raise ValueError(f"batch keys {sorted(batch)}, want {sorted(static)}")
    for key, dst in static.items():
        host = _host_tensor(np.asarray(batch[key]))
        if host.shape != dst.shape or host.dtype != dst.dtype:
            raise ValueError(f"{key}: {tuple(host.shape)} {host.dtype}, want "
                             f"{tuple(dst.shape)} {dst.dtype}")
        if dst.is_cuda:
            dst.copy_(host.pin_memory(), non_blocking=True)
        else:
            dst.copy_(host)
