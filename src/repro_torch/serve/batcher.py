"""Batch handler for generator-fired inference (paper §3.4.4 applied).

Port of the reference's ``serve/batcher.py::make_batch_handler``. A
ColonyOS generator packs requests into one ``generate_batch`` process;
the handler pads the prompts into one batch, runs the engine once and
publishes each request's tokens under ``/results/<request_id>.json``.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

RESULTS_LABEL = "/results"


def pad_prompts(requests: list[dict]) -> np.ndarray:
    """Right-align the prompts in a (B, longest) batch, left-padded with
    token 0 and no attention mask, as the reference batcher does."""
    longest = max(len(r["prompt"]) for r in requests)
    prompts = np.full((len(requests), longest), 0, np.int32)
    for i, r in enumerate(requests):
        p = r["prompt"]
        prompts[i, longest - len(p):] = p
    return prompts


def make_batch_handler(engine, cfs, colony: str):
    """Executor handler for the generator-fired 'generate_batch' function.

    ``cfs`` is anything with ``upload_bytes(colony, label, name, data)``.
    """

    def generate_batch(ctx, **kwargs) -> list[Any]:
        requests = kwargs.get("packed_args", [])
        if not requests:
            return [0]
        max_new = max(int(r.get("max_new_tokens", 8)) for r in requests)
        out = engine.generate(pad_prompts(requests), max_new_tokens=max_new)
        for i, r in enumerate(requests):
            cfs.upload_bytes(
                colony,
                RESULTS_LABEL,
                f"{r['request_id']}.json",
                json.dumps({"tokens": out[i].tolist()}).encode(),
            )
        return [len(requests)]

    return generate_batch


def result_tokens(cfs, colony: str, request_id: str) -> list[int]:
    """The tokens ``generate_batch`` published for ``request_id``."""
    return json.loads(cfs.download_bytes(colony, RESULTS_LABEL, f"{request_id}.json"))["tokens"]
