"""Serving launcher of the port: boots a ``ServeExecutor`` (optionally from a
trained CFS run) behind the generator-based dynamic batcher, then runs a
request load through the broker.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b --variant full --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --variant full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --variant no-moe
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b --variant smoke --device cpu

As in the reference, ``main`` starts a broker in this process
(``repro_torch.broker.standalone_server``), a ``ServeExecutor`` on
``--device``, a generator of queuesize ``--batch-size`` whose workflow is
one ``generate_batch``, and an ``InferenceClient``; each request is a
``pack`` and its tokens come back through CFS. The executor builds the
weights in float32 from seed 0 (``runtime.train_loop.serve_engine``, as the
reference's executor does), or restores ``--run``'s latest checkpoint;
``--seed`` draws the prompts. A variant whose float32 parameters alone
exceed the device's memory (on an 80 GB card: mixtral's ``half-depth``,
deepseek's ``two-moe``) is refused before any weight is built; the
``build_engine`` path below serves those in bf16.

Where it differs from the reference: the generator drains all it holds
when it fires, so requests submitted all at once would form batches that
depend on timing. Requests therefore go in waves of ``--batch-size``, each
after the generator has fired the one before (its processes hold it),
and the generator's ``timeout`` fires a trailing partial wave. ``main``
then waits on each ``generate_batch`` process the generator fired, which
gives the batches the broker formed, and reads the tokens from CFS. A
failed batch (llama-3.2-vision and seamless-m4t cross-attend to a memory
that the batch handler does not pass, ROADMAP C19, and raise
``ValueError`` naming it) ends that wait: ``main`` prints its error and
exits 1.

``build_engine``, ``make_requests`` and ``serve`` run the batch handler in
this process without a broker, on weights in the config's own dtype.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..broker import standalone_server
from ..configs import get_config
from ..core import Colonies, Crypto, InProcTransport
from ..core.fs import CFSClient, MemoryStorage
from ..device import resolve_device
from ..models.model import dtype_of
from ..models.spec import count_params, init_params, model_spec
from ..runtime.torch_executor import ServeExecutor
from ..serve.batcher import InferenceClient, make_batch_handler
from ..serve.engine import ServeEngine

COLONY = "serve"
EXECUTORTYPE = "torch-serve"
WAVE_TIMEOUT_S = 2.0  # the generator fires a partial wave this long after its first request
RESULT_TIMEOUT_S = 300.0  # a request's wait for its tokens, as the reference waits
POLL_S = 0.05


def build_engine(arch: str, variant: str, max_len: int, seed: int = 0,
                 device: str | torch.device = "cuda") -> ServeEngine:
    """Config + random weights from ``seed``, built directly on ``device``."""
    cfg = get_config(arch, variant)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(model_spec(cfg), gen, dtype_of(cfg.param_dtype), dev)
    return ServeEngine(cfg, params, max_len=max_len, device=dev)


def make_requests(prompt_lens: list[int], vocab: int, max_new_tokens: int,
                  seed: int = 0) -> list[dict]:
    """Requests as the generator packs them, with prompts drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [
        {"request_id": f"req-{i:04d}", "prompt": rng.integers(0, vocab, n).tolist(),
         "max_new_tokens": max_new_tokens}
        for i, n in enumerate(prompt_lens)
    ]


def serve(engine: ServeEngine, requests: list[dict], batch_size: int, sink,
          colony: str = "serve") -> list[float]:
    """Answer ``requests`` in batches of ``batch_size``; returns the wall
    seconds of each batch, taken after the device has finished it."""
    handler = make_batch_handler(engine, sink, colony)
    seconds = []
    for i in range(0, len(requests), batch_size):
        t0 = time.perf_counter()
        handler(None, packed_args=requests[i : i + batch_size])
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def device_memory(dev: torch.device) -> int:
    """Bytes of memory on ``dev``: the card's, or the host's for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _wait_fired(client: Colonies, n: int, prv: str) -> list[dict]:
    """The colony's ``generate_batch`` processes in the order the broker
    submitted them, once they hold all ``n`` requests packed so far (the
    generator has fired every wave)."""
    deadline = time.monotonic() + RESULT_TIMEOUT_S
    while time.monotonic() < deadline:
        fired = client.get_processes(COLONY, prv, count=n + 1)
        if sum(len(p["spec"]["kwargs"]["packed_args"]) for p in fired) == n:
            return sorted(fired, key=lambda p: p["submissiontime"])
        time.sleep(POLL_S)
    raise TimeoutError(f"the generator still holds requests after {RESULT_TIMEOUT_S} s")


def main(argv: list[str] | None = None) -> dict:
    """Serve ``--requests`` prompts through the broker and print each
    request's id, prompt length and tokens, then the engine's stats and
    the wall time. Returns what it printed (``requests``: id, prompt and
    tokens; ``batches``: the request ids of each ``generate_batch`` in the
    order the broker took them; ``stats``; ``wall_s``) and the ``engine``
    it served with, for callers that check the tokens against it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--variant", default="full",
                    help="full | smoke | an arch's own variant (jamba: no-moe, smoke-no-moe; "
                         "mixtral: half-depth; deepseek-v3-671b: two-moe)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-prompt-len", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0, help="draws the prompts")
    ap.add_argument("--run", default=None, help="CFS run to load a checkpoint from")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, args.variant)
    dev = resolve_device(args.device)
    need, have = 4 * count_params(model_spec(cfg)), device_memory(dev)
    if need > have:
        raise SystemExit(f"{args.arch} {args.variant}: {need} bytes of float32 parameters do not "
                         f"fit the {have} bytes of {dev}")
    lens = np.random.default_rng(args.seed).integers(1, args.max_prompt_len + 1, args.requests)
    requests = make_requests(lens.tolist(), cfg.vocab_size, args.max_new_tokens, args.seed)

    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    server = standalone_server(Crypto.id(server_prv))
    server.start_background(failsafe_interval=0.1)
    worker = None
    try:
        client = Colonies(InProcTransport([server]))
        client.add_colony(COLONY, Crypto.id(colony_prv), server_prv)
        storage = MemoryStorage()
        worker = ServeExecutor(client, COLONY, "serve-0", EXECUTORTYPE, storage,
                               colony_prvkey=colony_prv, arch=args.arch, variant=args.variant,
                               max_len=args.max_prompt_len + args.max_new_tokens, run=args.run,
                               device=dev)
        worker.start(poll_timeout=0.2)
        wf = {"colonyname": COLONY, "functionspecs": [
            {"nodename": "batch", "funcname": "generate_batch",
             "conditions": {"executortype": EXECUTORTYPE, "dependencies": []},
             "maxexectime": 300}]}
        g = client.add_generator(
            {"colonyname": COLONY, "name": "batcher", "queuesize": args.batch_size,
             "timeout": WAVE_TIMEOUT_S, "workflow": wf}, colony_prv)
        infc = InferenceClient(client, CFSClient(client, storage, colony_prv), COLONY,
                               g["generatorid"], colony_prv)
        t0 = time.perf_counter()
        rids, fired = [], []
        for i in range(0, len(requests), args.batch_size):
            rids += [infc.submit(r["prompt"], max_new_tokens=r["max_new_tokens"])
                     for r in requests[i : i + args.batch_size]]
            fired = _wait_fired(client, len(rids), colony_prv)
        batches = []
        for p in fired:
            done = client.wait(p["processid"], colony_prv, timeout=RESULT_TIMEOUT_S)
            if done["state"] != "successful":
                err = done["errors"][0] if done["errors"] else "no error text"
                print(f"generate_batch failed: {err}", file=sys.stderr)
                raise SystemExit(1)
            batches.append([r["request_id"] for r in done["spec"]["kwargs"]["packed_args"]])
        tokens = [infc.wait(rid, timeout=RESULT_TIMEOUT_S) for rid in rids]
        wall_s = time.perf_counter() - t0
    finally:
        if worker is not None:
            worker.stop()
        server.stop()
    out = [{"request_id": rid, "prompt": r["prompt"], "tokens": t}
           for rid, r, t in zip(rids, requests, tokens)]
    for o in out:
        print(o["request_id"], len(o["prompt"]), o["tokens"])
    st = dict(worker.engine.stats)
    print(f"{st['requests']} requests in {st['batches']} batches, {st['tokens']} tokens, "
          f"{wall_s:.3f}s on {worker.engine.device} (batches of {[len(b) for b in batches]})")
    return {"requests": out, "batches": batches, "stats": st, "wall_s": wall_s,
            "engine": worker.engine}


if __name__ == "__main__":
    main()
