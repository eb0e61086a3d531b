"""Serving engine: prefill + decode with sampling.

Port of the reference's ``serve/engine.py``. Eager PyTorch stands in for
the jitted prefill and decode steps. Greedy decoding is ``argmax`` and
matches the reference token for token; with temperature > 0 tokens are
drawn from a ``torch.Generator`` seeded by ``seed``, which cannot
reproduce ``jax.random.categorical``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..data.pipeline import to_device
from ..device import resolve_device
from ..models.model import decode_step, prefill
from ..tree import map_leaves


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: torch.Generator | None) -> torch.Tensor:
    """logits: (B, 1, V) -> (B, 1) int64."""
    last = logits[:, -1]
    if temperature <= 0.0:
        return last.argmax(dim=-1, keepdim=True)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


class ServeEngine:
    """Host-side generation loop over prefill and decode steps.

    ``params`` is moved to ``device`` (a no-op when it already lives there).
    """

    def __init__(self, cfg: ModelConfig, params: Any, max_len: int = 256,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = map_leaves(lambda t: t.to(self.device), params)
        self.max_len = max_len
        self.stats = {"requests": 0, "tokens": 0, "batches": 0}

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
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = prefill(self.params, self.cfg, batch, max_len=self.max_len)
        tok = sample_token(logits, temperature, gen)
        out = [tok]
        for pos in range(s, s + max_new_tokens - 1):
            logits, cache = decode_step(self.params, self.cfg, tok, cache, pos)
            tok = sample_token(logits, temperature, gen)
            out.append(tok)
        self.stats["requests"] += b
        self.stats["tokens"] += b * max_new_tokens
        self.stats["batches"] += 1
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
