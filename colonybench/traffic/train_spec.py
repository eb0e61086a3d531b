"""Traffic kind ``train_spec``: one ``train`` function spec through the
port's broker to a ``TrainerExecutor``, as a ColonyOS user submits it.

Two processes: the broker (``colonybench.broker``) and this one, which
submits the spec and holds the executor under test on the card. The
handler (``runtime.train_loop.train``) builds the state from the spec's
seed, one ``TrainStep``, and steps it over the synthetic stream the spec
names; no checkpoint falls inside a run (``checkpoint_every`` lies beyond
its steps).

The harness observes the step through a subclass of ``TrainStep`` put in
``train_loop``'s namespace, which changes nothing the step does: it keeps
the first three steps' losses, each leaf's gradient norm as the optimizer
got it at the first step (its first moment over 1 - beta1) and each
leaf's change over the three, and each step's end. The first three steps
(the eager warm-up, the capture and the first replay) and these readings
are set-up (the readings' own time left out of ``setup_s``); the window
opens when the readings are taken, and the fourth step starts then.
After the window closes the next step raises ``SimulatedCrash`` on entry,
so the handler ends as a crashed attempt and the run does not wait for its
final save. With ``--trace 1`` two more replayed steps run under the
profiler first.
"""

from __future__ import annotations

import gc
import json
import statistics
import tempfile
import shutil
import threading
import time

from ..window import credits

COLONY = "bench"
EXECUTOR_TYPE = "bench-train"
OBSERVED = 3  # steps the reference follows; the window opens after them
TRACED = 2  # replayed steps under the profiler, after the window


class _Observer:
    """What the observing step records, and the harness's signals to it."""

    def __init__(self, tracer, beta1: float) -> None:
        self.tracer, self.beta1 = tracer, beta1
        self.losses: list[float] = []
        self.grad_norm: dict[str, float] = {}
        self.change_norm: dict[str, float] = {}
        self.ends: list[float] = []  # time.time() at the end of each step
        self.reading_s = 0.0  # the harness's own time inside set-up
        self.opened = threading.Event()
        self.t_open: float | None = None
        self.close_at: float | None = None
        self.traced_steps = 0
        self._start: dict = {}

    def observe(self, step_cls):
        import torch
        from repro_torch.runtime.chaos import SimulatedCrash

        from ..weights import leaves as _leaves

        obs = self

        class ObservedTrainStep(step_cls):
            def __call__(self, batch):
                n = len(obs.ends)
                if obs.close_at is not None and time.time() >= obs.close_at:
                    if obs.tracer is not None and obs.traced_steps < TRACED:
                        if obs.tracer.prof is None:
                            obs.tracer.start()
                        obs.traced_steps += 1
                    else:
                        if obs.tracer is not None and obs.tracer.active:
                            obs.tracer.stop()
                        raise SimulatedCrash("the benchmark's window has closed")
                if n == 0:
                    t0 = time.perf_counter()
                    obs._start = {k: v.detach().to("cpu", copy=True)
                                  for k, v in _leaves(self.state["params"])}
                    obs.reading_s += time.perf_counter() - t0
                metrics = super().__call__(batch)
                loss = float(metrics["loss"])  # waits for the step
                obs.ends.append(time.time())
                if n < OBSERVED:
                    t0 = time.perf_counter()
                    obs.losses.append(loss)
                    with torch.no_grad():
                        if n == 0:
                            obs.grad_norm = {k: (m.norm() / (1 - obs.beta1)).item()
                                             for k, m in _leaves(self.state["opt"]["m"])}
                        if n == OBSERVED - 1:  # a layer at a time: little beside the pool
                            for k, p in _leaves(self.state["params"]):
                                p0 = obs._start.pop(k)
                                rows = zip(p, p0) if p.dim() >= 3 else [(p, p0)]
                                sq = sum((a - b.to(a.device)).square().sum().item()
                                         for a, b in rows)
                                obs.change_norm[k] = sq ** 0.5
                    obs.reading_s += time.perf_counter() - t0
                    if n == OBSERVED - 1:  # the window opens once the readings are taken
                        obs.t_open = time.time()
                        obs.opened.set()
                return metrics

        return ObservedTrainStep


def _gap(program: float, reference: float, floor: float) -> float:
    return abs(program - reference) / max(abs(reference), floor)


def compare(readings: dict, ref: dict) -> dict:
    """The three numbers a training cell is held to: the worst step's loss
    gap (relative), and the worst leaf's gap of the first gradient's norm
    and of the change's norm, each against the larger of the reference
    leaf's norm and the median leaf's. Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the change."""
    losses = max(_gap(p, r, 0.0) for p, r in zip(readings["loss"], ref["loss"]))
    g_med = statistics.median(ref["grad_norm"].values())
    c_med = statistics.median(ref["change_norm"].values())
    grads = max(_gap(readings["grad_norm"][k], r, g_med) for k, r in ref["grad_norm"].items())
    moved = [k for k, g in ref["grad_norm"].items() if g >= 1e-3 * g_med]
    changes = max(_gap(readings["change_norm"][k], ref["change_norm"][k], c_med) for k in moved)
    return {"loss_gap": losses, "grad_norm_gap": grads, "change_norm_gap": changes}


def run(ctx) -> dict:
    import torch
    from repro_torch.core.client import Colonies
    from repro_torch.core.crypto import Crypto
    from repro_torch.core.fs import LocalStorage
    from repro_torch.core.http_transport import HttpTransport
    from repro_torch.core.spec import FunctionSpec
    from repro_torch.runtime import torch_executor as tx
    from repro_torch.runtime import train_loop

    from ..broker import BrokerProcess
    from ..reference import train as rt
    from ..trace import Tracer

    mix, cfg, seed = ctx.mix, ctx.cfg, ctx.seed
    device = torch.device(ctx.device)
    hp = rt.Hyper(steps=mix["steps"], batch=mix["batch"], seq_len=mix["seq_len"],
                  learning_rate=mix["learning_rate"], warmup_steps=mix["warmup_steps"])
    tracer = Tracer() if ctx.trace else None
    obs = _Observer(tracer, hp.beta1)
    server_prv, colony_prv = Crypto.prvkey(), Crypto.prvkey()
    blobs = tempfile.mkdtemp(prefix="colonybench-blobs-")
    step_cls = train_loop.TrainStep
    broker = ex = None
    idle = threading.Event()
    try:
        broker = BrokerProcess(ctx.src, Crypto.id(server_prv))
        client = Colonies(HttpTransport("127.0.0.1", broker.port))
        client.add_colony(COLONY, Crypto.id(colony_prv), server_prv)
        ex = tx.TrainerExecutor(Colonies(HttpTransport("127.0.0.1", broker.port)), COLONY,
                                "bench-train", EXECUTOR_TYPE, LocalStorage(blobs),
                                colony_prvkey=colony_prv, device=device)
        for hook in ctx.hooks:
            hook(ex)
        train_loop.TrainStep = obs.observe(step_cls)
        execute = ex._execute

        def ending_execute(process):
            try:
                execute(process)
            finally:
                idle.set()

        ex._execute = ending_execute
        ex.start(poll_timeout=1.0)
        kwargs = {"arch": cfg["port"]["arch"], "variant": ctx.variant, "steps": hp.steps,
                  "batch": hp.batch, "seq_len": hp.seq_len, "optimizer": "adamw",
                  "learning_rate": hp.learning_rate, "warmup_steps": hp.warmup_steps,
                  "checkpoint_every": mix["checkpoint_every"], "seed": seed, "run": "bench"}
        client.submit(FunctionSpec.from_dict({
            "conditions": {"colonyname": COLONY, "executortype": EXECUTOR_TYPE},
            "funcname": "train", "kwargs": kwargs, "maxexectime": 3600}), colony_prv)
        while not obs.opened.wait(1.0):
            if idle.is_set():
                raise RuntimeError("the train handler ended before its third step")
        t_open = obs.t_open
        setup_s = time.perf_counter() - ctx.t_start - (time.time() - t_open) - obs.reading_s
        obs.close_at = t_open + ctx.seconds
        if not idle.wait(ctx.seconds + 600):
            raise RuntimeError("the train handler did not end after the window")
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        ex.stop()
    finally:
        train_loop.TrainStep = step_cls
        if broker is not None:
            broker.close()
        shutil.rmtree(blobs, ignore_errors=True)
    del ex
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary = tracer.summary() if tracer is not None else None

    close = t_open + ctx.seconds
    # every step that ended in the window, and the one in flight at its
    # close by the share of its span inside it
    shares = credits(obs.ends[OBSERVED:], t_open, close)
    steps = sum(shares)
    in_window = [s for s in shares if s == 1.0]
    readings = {"loss": obs.losses, "grad_norm": obs.grad_norm, "change_norm": obs.change_norm}
    t_check = time.perf_counter()
    complete = len(obs.losses) == OBSERVED and len(obs.change_norm) > 0
    gaps = compare(readings, rt.first_steps(cfg, hp, seed, device)) if complete else {
        "loss_gap": float("inf"), "grad_norm_gap": float("inf"), "change_norm_gap": float("inf")}
    check_s = time.perf_counter() - t_check
    notes = [f"window: {len(in_window)} steps of {hp.batch} x {hp.seq_len} tokens ended in it, "
             f"{steps:.4f} counted; "
             f"{len(obs.ends)} steps in the run; harness readings {obs.reading_s:.1f} s "
             f"left out of setup_s",
             "steps (ended, s after the open): " + ", ".join(
                 f"{t - t_open:.2f}" for t in obs.ends[OBSERVED:]),
             f"check: the first {OBSERVED} steps against the reference in {check_s:.1f} s; "
             f"losses {obs.losses}; " + json.dumps(gaps)]
    if ctx.control and complete:
        notes.append("control: " + json.dumps(control_readings(cfg, hp, seed, device)))
    limits = ctx.limits
    return {
        "setup_s": setup_s,
        "end_to_end": {"train_tokens_per_s": steps * hp.batch * hp.seq_len / ctx.seconds},
        "attempted": OBSERVED + len(in_window),
        "failed": 0 if complete else OBSERVED,
        "checks": {name: (value, limits[name]) for name, value in gaps.items()},
        "memory_peak_bytes": peak,
        "notes": notes,
        "run": {"seconds": ctx.seconds, "steps_in_window": steps, "config": cfg,
                "train_shape": {"batch": hp.batch, "seq_len": hp.seq_len},
                "trace": summary, "trace_counts": {"train_steps": obs.traced_steps}},
    }


def control_readings(cfg: dict, hp, seed: int, device) -> dict:
    """The control (the reference in TF32 in the program's place) and the
    faults planted in the reference (half of each batch left out, the mean
    taken over the rest; one token of the first batch altered), each read
    against the float32 reference as the program is."""
    from ..reference import models
    from ..reference import train as rt

    with models.precision("float32"):
        ref = rt.first_steps(cfg, hp, seed, device)
    out = {}
    with models.precision("tf32"):
        out["tf32"] = compare(rt.first_steps(cfg, hp, seed, device), ref)

    def half(step):
        toks = rt.batch_at(seed, step, hp.batch, hp.seq_len, cfg["vocab_size"])
        toks[hp.batch // 2:] = toks[: hp.batch - hp.batch // 2]
        return toks

    def altered(step):
        toks = rt.batch_at(seed, step, hp.batch, hp.seq_len, cfg["vocab_size"])
        if step == 0:
            toks[0, 1] = (toks[0, 1] + 1) % cfg["vocab_size"]
        return toks

    with models.precision("float32"):
        out["half_batch"] = compare(rt.first_steps(cfg, hp, seed, device, batch_fn=half), ref)
        out["altered_token"] = compare(rt.first_steps(cfg, hp, seed, device, batch_fn=altered),
                                       ref)
    return out
