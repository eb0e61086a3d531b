"""The train and eval steps over static buffers (``TrainStep``,
``EvalStep``): captured in a CUDA graph after ``WARMUP_STEPS`` real steps
on a card, run directly on the CPU.

On the CPU, at smoke size in float32: ``TrainStep`` against the
reference's ``jax.jit(make_train_step)`` over three steps at
``tests/test_torch_train.py``'s bars (state at atol 1e-5 / rtol 1e-4,
metrics at atol 1e-5; the gradient norm, a float32 sum over every leaf,
also within rtol 1e-5: rwkv6's, 33 to 79, is 1.9e-6 of itself off the
reference's on the port's XLA path as on the twin) for stablelm (AdamW at
1 and 2 microbatches,
Adafactor), rwkv6 through B2's plain twin and jamba with experts through
B3's (``use_pallas``; the reference trains on its XLA path); ``EvalStep``
against the reference's jitted eval step at atol 1e-5; for all ten archs,
both against their eager bodies bit for bit over the warm-up and two more
steps, with the state's tensors kept and the step counter advanced in
place; a run no longer than the warm-up; and ``train_loop.train``'s
crash and resume against the straight run, each run's step closed.

The ``cuda`` tests (``-m cuda`` on a card): captured against eager bit for
bit for all ten archs under deterministic algorithms; no host sync in the
replay loop; exact kernel launch counts per replay; a capture on a worker
thread, backward included, while the main thread uses the card; and a
train handler's memory given back after it returns or crashes.
"""

import gc
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import make_eval_step as ref_make_eval_step
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.pipeline import SyntheticTokens, to_device
from repro_torch.interop import params_from_reference, state_from_reference, state_to_reference
from repro_torch.kernels import launches as kl
from repro_torch.models import init_params, model_spec
from repro_torch.runtime import train_loop as tl
from repro_torch.runtime.store import MemoryStore
from repro_torch.train.train_step import (
    WARMUP_STEPS, EvalStep, TrainStep, init_state, make_eval_step, make_train_step,
    split_microbatches,
)
from repro_torch.tree import leaves, leaves_with_names, map_leaves

# cuBLAS is deterministic only with a fixed workspace, which torch reads
# once, at its first product on the card: set before any test touches it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ARCHS = ["stablelm-3b", "granite-3-8b", "starcoder2-15b", "qwen2.5-14b", "mixtral-8x7b",
         "rwkv6-7b", "jamba-1.5-large-398b", "deepseek-v3-671b", "llama-3.2-vision-11b",
         "seamless-m4t-large-v2"]
B, S = 4, 16
GATE = 1.0  # every cross-attention gate (0 at init, where the memory reaches nothing)


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


def _set_gates(params, value):
    for key, val in params.items():
        if key == "gate":
            val.fill_(value)
        elif isinstance(val, dict):
            _set_gates(val, value)


def _tcfg(microbatches=2, optimizer="adamw"):
    return TrainConfig(optimizer=optimizer, learning_rate=1e-3, warmup_steps=1, total_steps=10,
                       microbatches=microbatches)


def _params(cfg, device="cpu"):
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    _set_gates(params, GATE)
    return map_leaves(lambda p: p.to(device), params)


def _batches(cfg, n, microbatches, seed=1):
    data = SyntheticTokens(cfg, B, S, seed=seed)
    out = [data.batch_at(i) for i in range(n)]
    return [split_microbatches(h, microbatches) if microbatches > 1 else h for h in out]


def _eager_run(cfg, tcfg, params, batches):
    """The eager body ``make_train_step`` over ``batches`` from a copy of
    ``params``: (the final state, each step's metrics as floats)."""
    state = init_state(map_leaves(torch.clone, params), tcfg)
    step = make_train_step(cfg, tcfg)
    metrics = []
    for host in batches:
        state, m = step(state, to_device(host, leaves(params)[0].device))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _graph_run(cfg, tcfg, params, batches):
    """``TrainStep`` over ``batches`` from a copy of ``params``: (the state,
    each step's metrics as floats, the step), checking after every step
    that the state holds the same tensors and its counter advanced."""
    state = init_state(map_leaves(torch.clone, params), tcfg)
    counter, tensors = state["step"], [id(t) for t in leaves(state)]
    step = TrainStep(cfg, tcfg, state)
    metrics = []
    for i, host in enumerate(batches):
        metrics.append({k: float(v) for k, v in step(host).items()})
        assert step.state is state and state["step"] is counter
        assert [id(t) for t in leaves(state)] == tensors
        assert int(counter) == i + 1 and counter.dtype == torch.int32
    return state, metrics, step


def _assert_states_equal(got, want):
    for (name, a), (_, b) in zip(leaves_with_names(got), leaves_with_names(want), strict=True):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# against the reference's jitted steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,optimizer,microbatches", [
    ("stablelm-3b", "adamw", 1), ("stablelm-3b", "adamw", 2), ("stablelm-3b", "adafactor", 1),
    ("rwkv6-7b", "adamw", 1), ("jamba-1.5-large-398b", "adamw", 1)])
def test_train_step_matches_the_reference_jit_over_three_steps(arch, optimizer, microbatches):
    rcfg = _f32(ref_get_config(arch, "smoke"))
    cfg = _f32(get_config(arch, "smoke")).copy(use_pallas=True)  # the kernels' plain twins
    kw = dict(optimizer=optimizer, learning_rate=1e-3, warmup_steps=1, total_steps=10,
              microbatches=microbatches)
    rt, tt = RefTrainConfig(**kw), TrainConfig(**kw)
    rstate = ref_init_state(R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32), rt)
    state = state_from_reference(jax.tree.map(np.asarray, rstate))
    ref_step = jax.jit(ref_make_train_step(rcfg, rt))
    step = TrainStep(cfg, tt, state)
    for host in _batches(cfg, 3, microbatches):
        rstate, rmetrics = ref_step(rstate, {k: jnp.asarray(v) for k, v in host.items()})
        metrics = step(host)
        assert sorted(metrics) == sorted(rmetrics)
        for key in rmetrics:
            bar = dict(abs=1e-5, rel=1e-5 if key == "grad_norm" else 0)
            assert float(metrics[key]) == pytest.approx(float(rmetrics[key]), **bar), key
    assert int(state["step"]) == int(rstate["step"]) == 3
    got = leaves_with_names(state_to_reference(state))
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4, err_msg=name)


def test_eval_step_matches_the_reference_jit():
    rcfg = _f32(ref_get_config("stablelm-3b", "smoke"))
    rparams = R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32)
    ref_eval = jax.jit(ref_make_eval_step(rcfg, RefTrainConfig()))
    step = EvalStep(_f32(get_config("stablelm-3b", "smoke")), TrainConfig(),
                    params_from_reference(jax.tree.map(np.asarray, rparams)))
    data = SyntheticTokens(rcfg, B, S, seed=9999)
    for i in range(WARMUP_STEPS + 2):
        host = data.batch_at(i)
        want = ref_eval(rparams, {k: jnp.asarray(v) for k, v in host.items()})
        got = step(host)
        assert sorted(got) == sorted(want)
        for key in want:
            assert float(got[key]) == pytest.approx(float(want[key]), abs=1e-5), key


# ---------------------------------------------------------------------------
# against the eager bodies, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_equal_their_eager_bodies_bit_for_bit(arch):
    """2 microbatches, the warm-up and two more steps; then the eval step
    on the trained parameters against ``make_eval_step``."""
    cfg, tcfg = _f32(get_config(arch, "smoke")), _tcfg()
    params = _params(cfg)
    batches = _batches(cfg, WARMUP_STEPS + 2, tcfg.microbatches)
    want_state, want = _eager_run(cfg, tcfg, params, batches)
    state, got, step = _graph_run(cfg, tcfg, params, batches)
    assert got == want
    assert step.calls == WARMUP_STEPS + 2 and step.graph is None  # no graph on the CPU
    _assert_states_equal(state, want_state)
    evals = SyntheticTokens(cfg, B, S, seed=9999)
    eval_step, body = EvalStep(cfg, tcfg, state["params"]), make_eval_step(cfg, tcfg)
    for i in range(WARMUP_STEPS + 2):
        host = evals.batch_at(i)
        got, want = eval_step(host), body(state["params"], to_device(host, "cpu"))
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), arch


def test_a_run_no_longer_than_the_warm_up_is_the_eager_body():
    """``train`` of ``WARMUP_STEPS`` steps never captures: its metrics and
    checkpoint are the eager body's."""
    kw = dict(arch="stablelm-3b", steps=WARMUP_STEPS, batch=B, seq_len=S, warmup_steps=1,
              learning_rate=1e-3, checkpoint_every=1)
    store = MemoryStore()
    (out,) = tl.train(store, "dev", device="cpu", run="short", **kw)
    cfg = tl._smoke_cfg(kw)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=WARMUP_STEPS)
    data = SyntheticTokens(cfg, B, S, seed=0)
    state, metrics = _eager_run(cfg, tcfg, tl._init_params(cfg, tcfg, torch.device("cpu")),
                                [data.batch_at(i) for i in range(WARMUP_STEPS)])
    assert out["final_step"] == WARMUP_STEPS - 1 and out["metrics"] == metrics[-1]
    like = tl._init_state(cfg, tcfg, torch.device("cpu"))
    restored, step = tl.CheckpointManager(store, "dev", run="short").restore_latest(like)
    assert step == WARMUP_STEPS - 1
    _assert_states_equal(restored, state)


def test_crash_and_resume_equal_the_straight_run(monkeypatch):
    """Straight, and crashing at step 3 then resumed from the step-1
    checkpoint: the same metrics and parameters bit for bit; every run's
    ``TrainStep`` closed, the crashed one's too."""
    closed, close = [], TrainStep.close

    def recorded(self):
        closed.append(self.calls)
        close(self)

    monkeypatch.setattr(TrainStep, "close", recorded)
    kw = dict(arch="stablelm-3b", steps=6, batch=B, seq_len=S, checkpoint_every=2,
              warmup_steps=2, microbatches=2)
    store = MemoryStore()
    straight, trained = tl.train_run(store, "dev", device="cpu", run="straight", **kw)
    with pytest.raises(tl.SimulatedCrash, match="step 3"):
        tl.train(store, "dev", device="cpu", run="crashed", die_at_step=3, **kw)
    assert tl.CheckpointManager(store, "dev", run="crashed").latest_step() == 1
    resumed, state = tl.train_run(store, "dev", device="cpu", run="crashed", **kw)
    assert closed == [6, 3, 4]
    assert resumed[0]["metrics"] == straight[0]["metrics"]
    _assert_states_equal(state, trained)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_cfg(arch):
    _card()
    return _f32(get_config(arch, "smoke"))


@pytest.fixture()
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_captured_steps_equal_eager_bit_for_bit(arch, deterministic):
    """The warm-up, the capture and three replays against the eager body
    on the card: metrics and every state leaf equal; then the eval step."""
    cfg, tcfg = _card_cfg(arch), _tcfg()
    params = _params(cfg, "cuda")
    batches = _batches(cfg, WARMUP_STEPS + 3, tcfg.microbatches)
    want_state, want = _eager_run(cfg, tcfg, params, batches)
    state = init_state(map_leaves(torch.clone, params), tcfg)
    step = TrainStep(cfg, tcfg, state)
    got = []
    for i, host in enumerate(batches):
        got.append({k: float(v) for k, v in step(host).items()})
        assert (step.graph is None) == (i < WARMUP_STEPS), i
    assert got == want
    _assert_states_equal(state, want_state)
    evals = SyntheticTokens(cfg, B, S, seed=9999)
    eval_step, body = EvalStep(cfg, tcfg, state["params"]), make_eval_step(cfg, tcfg)
    for i in range(WARMUP_STEPS + 2):
        host = evals.batch_at(i)
        got = {k: float(v) for k, v in eval_step(host).items()}
        assert got == {k: float(v) for k, v in body(state["params"], to_device(host, "cuda")).items()}
    assert eval_step.graph is not None


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_replay_loop_has_no_host_sync(arch):
    cfg, tcfg = _card_cfg(arch), _tcfg()
    state = init_state(_params(cfg, "cuda"), tcfg)
    step = TrainStep(cfg, tcfg, state)
    batches = _batches(cfg, WARMUP_STEPS + 4, tcfg.microbatches)
    for host in batches[: WARMUP_STEPS + 1]:
        step(host)
    assert step.graph is not None
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(host)["loss"].clone() for host in batches[WARMUP_STEPS + 1:]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses = torch.stack(losses).tolist()
    assert all(np.isfinite(losses)) and len(set(losses)) == len(losses), losses


@pytest.mark.cuda
@pytest.mark.parametrize("arch,variant,kernels", [
    ("stablelm-3b", "smoke", {"flash_attention"}), ("rwkv6-7b", "smoke", {"rwkv6_wkv"}),
    ("jamba-1.5-large-398b", "smoke", {"flash_attention", "mamba_scan"}),
    ("deepseek-v3-671b", "smoke", {"flash_attention"})])
def test_cuda_each_replay_counts_the_eager_steps_launches(arch, variant, kernels):
    """An eager step's launches, counted by the wrappers; then every
    ``TrainStep`` call (warm-up, capture and replay, replays) adds exactly
    as many; the same for an eval batch and every ``EvalStep`` call."""
    cfg, tcfg = _f32(get_config(arch, variant)), _tcfg()
    _card()
    params = _params(cfg, "cuda")
    batches = _batches(cfg, WARMUP_STEPS + 3, tcfg.microbatches)
    for mod in kl.MODULES.values():
        mod.launches = 0
    _eager_run(cfg, tcfg, params, batches[:1])
    per_step = kl.counts()
    assert {name for name, n in per_step.items() if n} == kernels, per_step
    if arch == "stablelm-3b":  # each layer's forward and remat recomputation, per microbatch
        assert per_step["flash_attention"] == 2 * cfg.num_layers * tcfg.microbatches
    step = TrainStep(cfg, tcfg, init_state(params, tcfg))
    for i, host in enumerate(batches):
        before = kl.counts()
        step(host)
        assert {n: kl.counts()[n] - before[n] for n in before} == per_step, i
    assert step.graph is not None and step._launches.per_replay == per_step
    evals = SyntheticTokens(cfg, B, S, seed=9999)
    before = kl.counts()
    make_eval_step(cfg, tcfg)(params, to_device(evals.batch_at(0), "cuda"))
    per_eval = {n: kl.counts()[n] - before[n] for n in before}
    assert {name for name, n in per_eval.items() if n} == kernels, per_eval
    eval_step = EvalStep(cfg, tcfg, params)
    for i in range(WARMUP_STEPS + 2):
        before = kl.counts()
        eval_step(evals.batch_at(i))
        assert {n: kl.counts()[n] - before[n] for n in before} == per_eval, i
    assert eval_step.graph is not None


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-3b", "jamba-1.5-large-398b"])
def test_cuda_capture_on_a_worker_thread_while_the_main_thread_uses_the_card(
        arch, deterministic, monkeypatch):
    """A ``TrainStep`` built and run on a worker thread (as an executor's
    handler is) while the main thread multiplies on the card. B1's backward
    (through its plain twin, ``fa.plain_grads``) runs on the autograd
    engine's own thread, on the capturing stream during the capture; the
    replays equal the eager body's steps bit for bit."""
    from repro_torch.kernels import flash_attention as fa

    cfg, tcfg = _card_cfg(arch), _tcfg()
    params = _params(cfg, "cuda")
    batches = _batches(cfg, WARMUP_STEPS + 3, tcfg.microbatches)
    want_state, want = _eager_run(cfg, tcfg, params, batches)
    backward_on = set()  # (thread, capturing) of each B1 backward
    plain_grads = fa.plain_grads

    def recorded(*args, **kwargs):
        backward_on.add((threading.get_ident(), torch.cuda.is_current_stream_capturing()))
        return plain_grads(*args, **kwargs)

    monkeypatch.setattr(fa, "plain_grads", recorded)
    result, stop = {}, threading.Event()

    def worker():
        try:
            result["thread"] = threading.get_ident()
            state, metrics, step = _graph_run(cfg, tcfg, params, batches)
            result.update(state=state, metrics=metrics, graph=step.graph is not None)
        except Exception as exc:  # noqa: BLE001 - carried to the main thread
            result["error"] = exc
        finally:
            stop.set()

    x = torch.randn(512, 512, device="cuda")
    thread = threading.Thread(target=worker)
    thread.start()
    steps = 0
    while not stop.is_set():
        x = torch.tanh(x @ x)
        steps += 1
    thread.join(timeout=300)
    assert not thread.is_alive()
    torch.cuda.synchronize()
    assert "error" not in result, result.get("error")
    assert result["graph"] and steps > 0
    captured = {t for t, capturing in backward_on if capturing}
    assert captured and result["thread"] not in captured, backward_on
    assert result["metrics"] == want
    _assert_states_equal(result["state"], want_state)


@pytest.mark.cuda
def test_cuda_a_train_handler_gives_back_its_memory():
    """``train`` (straight, then crashing after its capture) and
    ``evaluate`` on the card, three rounds: from the second round on, what
    is allocated after each handler returns and what the allocator keeps
    after emptying its cache are what they were after the first."""
    _card()
    kw = dict(arch="stablelm-3b", steps=4, batch=B, seq_len=S, checkpoint_every=2)
    held = []
    for _ in range(3):
        store = MemoryStore()
        tl.train(store, "dev", device="cuda", run="r", **kw)
        with pytest.raises(tl.SimulatedCrash):
            tl.train(store, "dev", device="cuda", run="c", die_at_step=WARMUP_STEPS + 2, **kw)
        tl.evaluate(store, "dev", device="cuda", arch="stablelm-3b", run="r", batch=B, seq_len=S)
        del store
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held.append((torch.cuda.memory_allocated(), torch.cuda.memory_reserved()))
    assert held[1] == held[0] and held[2] == held[0], held
