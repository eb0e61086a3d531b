"""Traffic kind ``serve_generator``: requests through the port's broker to
a ``ServeExecutor``, batched by a ColonyOS generator.

Three processes: the broker (``colonybench.broker``), the clients
(``colonybench/clients.py``, a closed loop of ``clients`` clients, each
request a signed ``pack``) and this one, which holds the executor under
test on the card. The generator fires one ``generate_batch`` once
``queuesize`` packs are waiting (or ``timeout_s`` after the first), and
the executor's batch handler runs ``ServeEngine.generate`` on the padded
batch and publishes each request's tokens in CFS, whose blobs live in a
directory both processes read.

Set-up: the broker, the clients, the executor (which builds its own
weights, replaced at once by the benchmark's, made on the card from the
seed), then one wave through every layer at the window's prompts and
batch, each request asking for ``WARM_NEW_TOKENS``: it builds the kernels
on a checkout's first run, runs the prefill and captures the batch's
decode step (a decode key is the batch, the sampling and the cache's
shapes, not the number of steps). The window then opens. The harness wraps the program's calls to time them and
name them in a trace (``colonybench.*`` ranges), never to change them:
``_execute`` (assign to close), ``generate``, the prefill, the decode
replays and each broker RPC of the executor. With ``--trace 1`` the
profiler covers one more wave after the window has closed and every
request sent in it has come back, from before its packs to after its
results: a whole batch cycle of the same lengths, whose profile takes
tens of seconds to read, which would otherwise delay counted requests.
"""

from __future__ import annotations

import gc
import json
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from ..window import credits
from .requests import wave

COLONY = "bench"
EXECUTOR_TYPE = "bench-serve"
WARM_NEW_TOKENS = 2  # one decode replay in the warm-up wave


def _workflow() -> dict:
    return {"colonyname": COLONY,
            "functionspecs": [{"nodename": "batch", "funcname": "generate_batch",
                               "conditions": {"executortype": EXECUTOR_TYPE,
                                              "dependencies": []}}]}


class _Clients:
    """The clients' process and its line protocol."""

    def __init__(self, cfg: dict) -> None:
        script = Path(__file__).resolve().parents[1] / "clients.py"
        self.proc = subprocess.Popen([sys.executable, str(script), json.dumps(cfg)],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.ask(None)

    def ask(self, cmd: str | None) -> dict:
        if cmd is not None:
            self.proc.stdin.write(cmd + "\n")
            self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the clients' process ended (rc {self.proc.wait()})")
        return json.loads(line)

    def close(self) -> None:
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.proc.stdout.close()


class _Instruments:
    """The harness's wrappers around the executor's calls: batch records,
    the engine's time, and the ``colonybench.*`` ranges the trace reads."""

    def __init__(self, ex, tracer) -> None:
        import torch
        from repro_torch.serve import engine as engine_mod

        self.batches: list[dict] = []
        self.tracer = tracer
        self.start_requested = self.stop_requested = False
        self.counts = {"decode_replays": 0, "prefill_tokens": 0}
        self.idle = threading.Event()
        self.idle.set()
        rf = torch.profiler.record_function
        engine = ex.engine
        execute, generate, prefill = ex._execute, engine.generate, engine._prefill
        rpc = ex.client._rpc
        self._engine_mod, self._run = engine_mod, engine_mod.DecodeStep.run
        run = self._run
        current: dict = {}

        def timed_execute(process):
            self.idle.clear()
            packed = process.spec.kwargs.get("packed_args", [])
            current.clear()
            current.update(engine_s=0.0, start=time.time())
            try:
                with rf("colonybench.execute"):
                    execute(process)
            finally:
                self.batches.append({
                    "start": current["start"], "end": time.time(), "engine_s": current["engine_s"],
                    "rids": [r["request_id"] for r in packed],
                    "padded_len": max((len(r["prompt"]) for r in packed), default=0),
                    "max_new": max((int(r["max_new_tokens"]) for r in packed), default=0),
                    "traced": self.tracer is not None and self.tracer.active,
                    "logits": (current.get("prefill_logits"), current.get("last_logits"))})
                self.idle.set()

        def timed_generate(*args, **kwargs):
            t0 = time.perf_counter()
            with rf("colonybench.generate"):
                out = generate(*args, **kwargs)  # ends in a copy to the host
            current["engine_s"] += time.perf_counter() - t0
            return out

        def ranged_prefill(params, batch):
            if self.tracer is not None and self.tracer.active:
                self.counts["prefill_tokens"] += batch["tokens"].numel()
            with rf("colonybench.prefill"):
                logits, cache = prefill(params, batch)
            current["prefill_logits"] = logits[:, -1].clone()  # a copy on the card: no wait
            return logits, cache

        def ranged_run(step, steps):
            if self.tracer is not None and self.tracer.active:
                self.counts["decode_replays"] += steps
            with rf("colonybench.decode"):
                run(step, steps)
            if steps:
                current["last_logits"] = step.logits[:, -1].clone()

        def ranged_rpc(payloadtype, *args, **kwargs):
            with rf(f"colonybench.rpc.{payloadtype}"):
                return rpc(payloadtype, *args, **kwargs)

        step = ex.step

        def polled_step(timeout):
            # the profiler belongs to the thread that starts it: this one,
            # between two assigns
            if self.start_requested and self.tracer.prof is None:
                self.tracer.start()
            out = step(timeout)
            if self.stop_requested and self.tracer.active:
                self.tracer.stop()
            return out

        ex.step = polled_step
        ex._execute, engine.generate = timed_execute, timed_generate
        engine._prefill = ranged_prefill
        ex.client._rpc = ranged_rpc
        engine_mod.DecodeStep.run = ranged_run

    def restore(self) -> None:
        self._engine_mod.DecodeStep.run = self._run


def _wait(cond, seconds: float) -> None:
    deadline = time.time() + seconds
    while not cond():
        if time.time() > deadline:
            raise TimeoutError("the executor did not answer in time")
        time.sleep(0.1)


def _wait_idle(client, prvkey: str, generatorid: str, inst: _Instruments) -> None:
    """Until every batch the generator fired has closed and nothing waits."""
    def idle() -> bool:
        g = [x for x in client.get_generators(COLONY, prvkey) if x["generatorid"] == generatorid]
        return (g[0]["pending"] == 0 and g[0]["runs"] == len(inst.batches)
                and inst.idle.is_set())

    _wait(idle, 300)


def _row(logits, i: int, batch: int, vocab: int):
    """Row ``i`` of a batch's captured logits; infinite where the timed path
    gave the batch another number of rows (so the row cannot be right)."""
    import torch

    if logits is None:
        return None
    if logits.shape[0] != batch:
        return torch.full((vocab,), float("inf"))
    return logits[i]


def _by_wave(records: list[dict], t_open: float) -> dict[int, list[float]]:
    waves: dict[int, list[float]] = {}
    for r in records:
        waves.setdefault(r["wave"], []).append(r["published"] - t_open)
    return waves


def _p95(values: list[float]) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def run(ctx) -> dict:
    import torch
    from repro_torch.core.client import Colonies
    from repro_torch.core.crypto import Crypto
    from repro_torch.core.fs import LocalStorage
    from repro_torch.core.http_transport import HttpTransport
    from repro_torch.runtime import torch_executor as tx

    from .. import weights
    from ..broker import BrokerProcess
    from ..reference import check
    from ..trace import Tracer

    mix, cfg, seed = ctx.mix, ctx.cfg, ctx.seed
    device = torch.device(ctx.device)
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    blobs = tempfile.mkdtemp(prefix="colonybench-blobs-")
    broker = clients = ex = inst = None
    try:
        broker = BrokerProcess(ctx.src, Crypto.id(server_prv))
        harness = Colonies(HttpTransport("127.0.0.1", broker.port))
        harness.add_colony(COLONY, Crypto.id(colony_prv), server_prv)
        gen = harness.add_generator({"colonyname": COLONY, "name": ctx.workload,
                                     "queuesize": mix["queuesize"], "timeout": mix["timeout_s"],
                                     "workflow": _workflow()}, colony_prv)
        out_path = str(Path(blobs) / "clients.json")
        clients = _Clients({"src": str(ctx.src), "port": broker.port, "colony": COLONY,
                            "prvkey": colony_prv, "generatorid": gen["generatorid"],
                            "blobs": blobs, "mix": mix, "seed": seed,
                            "vocab": cfg["vocab_size"], "poll_s": mix["poll_s"],
                            "grace_s": mix["grace_s"], "out": out_path})
        ex = tx.ServeExecutor(Colonies(HttpTransport("127.0.0.1", broker.port)), COLONY,
                              "bench-serve", EXECUTOR_TYPE, LocalStorage(blobs),
                              colony_prvkey=colony_prv, arch=cfg["port"]["arch"],
                              variant=ctx.variant, max_len=mix["max_len"], device=device)
        params, _ = weights.make(cfg, seed, device)
        ex.engine.params = params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for hook in ctx.hooks:
            hook(ex)
        tracer = Tracer() if ctx.trace else None
        window = {}
        inst = _Instruments(ex, tracer)
        ex.start(poll_timeout=1.0)
        clients.ask(f"wave 0 {WARM_NEW_TOKENS}")
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - ctx.t_start
        window["open"] = time.time()
        window["close"] = window["open"] + ctx.seconds
        done = clients.ask(f"go {window['close']!r}")
        _wait_idle(harness, colony_prv, gen["generatorid"], inst)
        if tracer is not None:
            # one more wave after the window, traced from before its packs
            # to after its results: the profiler's cost delays no counted
            # request
            inst.start_requested = True
            _wait(lambda: tracer.active, 30)
            clients.ask(f"wave {done['last_wave'] + 1}")
            _wait_idle(harness, colony_prv, gen["generatorid"], inst)
            inst.stop_requested = True
            _wait(lambda: not tracer.active, 300)
        ex.stop()
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        summary = tracer.summary() if tracer is not None else None
    finally:
        if inst is not None:
            inst.restore()
        if clients is not None:
            clients.close()
        if broker is not None:
            broker.close()

    with open(out_path) as f:
        sent = json.load(f)
    shutil.rmtree(blobs, ignore_errors=True)
    batches, trace_counts = inst.batches, inst.counts
    del ex, inst
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_open, t_close = window["open"], window["close"]
    records = [r for r in sent["records"] if r["sent"] < t_close]
    finished = [r for r in records if "published" in r]
    latencies = [r["published"] - r["sent"] for r in finished]
    short = [r["rid"] for r in finished if len(r["tokens"]) < r["max_new_tokens"]]
    row_of = {rid: (b, i) for b in batches for i, rid in enumerate(b["rids"])}

    # the window's work: every batch whose results were all published by
    # the close, and the batch in flight then, credited by the share of its
    # span (from the last publication before it) that fell inside the window
    by_batch: dict[int, list[dict]] = {}
    for r in finished:
        by_batch.setdefault(id(row_of[r["rid"]][0]), []).append(r)
    units = sorted(by_batch.values(), key=lambda rs: max(r["published"] for r in rs))
    shares = credits([max(r["published"] for r in rs) for rs in units], t_open, t_close)
    counted = [dict(r, credit=share) for rs, share in zip(units, shares) if share > 0
               for r in rs]
    whole = sum(1 for share in shares if share == 1.0)
    partial = next((share for share in shares if 0.0 < share < 1.0), 0.0)

    # the check: a sample drawn from the seed, the longest request in it
    rng = random.Random(seed)
    by_size = sorted(finished, key=lambda r: r["prompt_len"] + r["max_new_tokens"])
    others = by_size[:-1]
    sample = by_size[-1:] + rng.sample(others, min(len(others), ctx.limits["check_requests"] - 1))
    waves: dict[int, list] = {}
    items = []
    for r in sample:
        w = waves.setdefault(r["wave"], wave(mix, seed, r["wave"], cfg["vocab_size"]))
        b, i = row_of[r["rid"]]
        items.append({"prompt": w[r["client"]]["prompt"], "padded_len": b["padded_len"],
                      "served": r["tokens"], "all": r["all_tokens"],
                      "prefill": _row(b["logits"][0], i, len(b["rids"]), cfg["vocab_size"]),
                      "last": _row(b["logits"][1], i, len(b["rids"]), cfg["vocab_size"])})
    for b in batches:
        del b["logits"]
    t_check = time.perf_counter()
    readings = check.served(params, cfg, items, device, ctx.limits["check_chunk"])
    check_s = time.perf_counter() - t_check
    control = check.control(params, cfg, items, device, ctx.limits["check_chunk"]) \
        if ctx.control else None

    tokens = sum(r["credit"] * (r["prompt_len"] + r["max_new_tokens"]) for r in counted)
    end_to_end = {"serve_tokens_per_s": tokens / ctx.seconds}
    if latencies:
        end_to_end["request_latency_p95_s"] = (_p95(latencies) if len(latencies) > 1
                                               else latencies[0])
    notes = [f"latency: {len(latencies)} requests, median {statistics.median(latencies):.4f} s, "
             f"p95 {end_to_end.get('request_latency_p95_s', float('nan')):.4f} s" if latencies
             else "latency: no request finished",
             f"window: {len(records)} requests sent, {len(finished)} finished, "
             f"{sum(1 for r in counted if r['credit'] == 1.0)} published in it, {tokens:.1f} "
             f"counted tokens: {whole} whole batches and {partial:.4f} of the next; "
             f"{len(batches)} batches in the run; {done}",
             f"check: {len(sample)} requests, {readings['tokens']} served tokens, reference "
             f"{check_s:.1f} s; readings " + json.dumps(readings),
             "waves (published, s after the open): " + ", ".join(
                 f"{w}: {min(ts):.2f}-{max(ts):.2f}" for w, ts in sorted(_by_wave(finished, t_open)
                                                                          .items()))]
    if control is not None:
        notes.append("control (the reference in TF32 in the program's place): "
                     + json.dumps(control))
    spans = [s for s in sent["spans"] if t_open <= s[1] <= t_close]
    return {
        "setup_s": setup_s,
        "end_to_end": end_to_end,
        "attempted": len(records),
        "failed": len(records) - len(finished) + len(short),
        "checks": dict(
            {name: (readings[name], ctx.limits[name])
             for name in ("max_logit_gap", "max_logit_error", "median_logit_error")
             if name in ctx.limits},
            unfinished_requests=(len(records) - len(finished), 0),
            short_answers=(len(short), 0)),
        "memory_peak_bytes": peak,
        "notes": notes,
        "run": {"window": window, "seconds": ctx.seconds, "requests": counted,
                "batches": [b for b in batches if t_open <= b["start"] <= t_close],
                "spans": spans, "trace": summary, "trace_counts": trace_counts,
                "config": cfg},
    }

