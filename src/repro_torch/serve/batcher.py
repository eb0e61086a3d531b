"""Dynamic batching through ColonyOS generators (paper §3.4.4 applied).

Port of the reference's ``serve/batcher.py``. Each inference request is a
fire-and-forget ``pack`` (``InferenceClient``); the generator fires one
``generate_batch`` process once ``queuesize`` requests accumulate (or the
timeout lapses); the handler pads the prompts into one batch, runs the
engine once and publishes each request's tokens under
``/results/<request_id>.json``, which requesters poll.
"""

from __future__ import annotations

import json
import secrets
import time
from typing import Any

import numpy as np

from .. import trace
from ..core.client import Colonies
from ..core.errors import NotFoundError, TimeoutError_
from ..core.fs import CFSClient

RESULTS_LABEL = "/results"


class InferenceClient:
    """Submit prompts as packs; poll CFS for results."""

    def __init__(self, client: Colonies, cfs: CFSClient, colony: str, generatorid: str, prvkey: str):
        self.client = client
        self.cfs = cfs
        self.colony = colony
        self.generatorid = generatorid
        self.prvkey = prvkey

    def submit(self, prompt_tokens: list[int], max_new_tokens: int = 8) -> str:
        rid = secrets.token_hex(8)
        self.client.pack(
            self.generatorid,
            {"request_id": rid, "prompt": list(map(int, prompt_tokens)), "max_new_tokens": max_new_tokens},
            self.prvkey,
        )
        return rid

    def result(self, rid: str) -> list[int] | None:
        try:
            data = self.cfs.download_bytes(self.colony, RESULTS_LABEL, f"{rid}.json")
        except NotFoundError:
            return None
        return json.loads(data)["tokens"]

    def wait(self, rid: str, timeout: float = 30.0, poll: float = 0.05) -> list[int]:
        deadline = time.time() + timeout
        while time.time() < deadline:
            r = self.result(rid)
            if r is not None:
                return r
            time.sleep(poll)
        raise TimeoutError_(f"request {rid} timed out")


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
    Spans (``trace.py``): ``serve.pad``, ``serve.generate`` (the batch's
    token slots as attributes) and one ``serve.publish`` a request (the
    request's id its trace id); counters ``serve.requests``,
    ``serve.batches`` and ``serve.<each token slot count>``.
    """

    def generate_batch(ctx, **kwargs) -> list[Any]:
        requests = kwargs.get("packed_args", [])
        if not requests:
            return [0]
        asked = [int(r.get("max_new_tokens", 8)) for r in requests]
        max_new = max(asked)
        with trace.span("serve.pad"):
            prompts = pad_prompts(requests)
        # the prompts' own tokens and the prefill's (every row padded to the
        # longest); the tokens asked for and the decode's (every row to the
        # largest ask)
        tokens = {"prompt_tokens": sum(len(r["prompt"]) for r in requests),
                  "prefill_tokens": int(prompts.size), "asked_tokens": sum(asked),
                  "decode_slots": len(requests) * max_new}
        trace.count("serve.requests", len(requests))
        trace.count("serve.batches")
        for name, n in tokens.items():
            trace.count(f"serve.{name}", n)
        with trace.span("serve.generate", **tokens):
            out = engine.generate(prompts, max_new_tokens=max_new)
        for i, r in enumerate(requests):
            with trace.span("serve.publish", trace_id=r["request_id"]):
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
