"""The port's launchers through the broker and the executors, on the CPU.

``launch.train`` submits a ``train`` and an ``evaluate`` spec to a
``TrainerExecutor`` behind an in-process broker: both outputs equal
``runtime.train_loop.train``/``evaluate`` called directly with the same
arguments. ``launch.serve`` answers its requests through a generator and a
``ServeExecutor``: the batches are the waves of ``--batch-size`` it
submits, and each request's tokens equal ``ServeEngine.generate``'s
(greedy) on the batch the broker formed, and the reference engine's on the
same weights. A llama-3.2-vision serve fails its batch (no memory, ROADMAP
C19) and exits 1 at once; a variant whose float32 parameters exceed the
device's memory is refused before any weight is built."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.interop import params_to_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import count_params, model_spec
from repro_torch.configs import get_config
from repro_torch.runtime import train_loop as tl
from repro_torch.runtime.store import MemoryStore
from repro_torch.serve.batcher import pad_prompts

TRAIN_ARGS = {"arch": "stablelm-3b", "steps": 2, "batch": 2, "seq_len": 16, "checkpoint_every": 2,
              "optimizer": "adamw", "microbatches": 2}


def _argv(kw: dict) -> list[str]:
    return [a for k, v in kw.items() for a in (f"--{k.replace('_', '-')}", str(v))]


def test_train_cli_equals_the_direct_handlers(capsys):
    outs = train_cli.main(_argv(TRAIN_ARGS) + ["--device", "cpu"])
    assert len(outs) == 2 and capsys.readouterr().out.count('"run": "cli-run"') == 2
    kw = dict(TRAIN_ARGS, run="cli-run", learning_rate=3e-4, use_pallas=False)
    store = MemoryStore()
    want = tl.train(store, "launch", device="cpu", **kw)
    ev = tl.evaluate(store, "launch", device="cpu", arch="stablelm-3b", variant="smoke",
                     optimizer="adamw", batch=2, seq_len=16, run="cli-run", use_pallas=False)
    (got,), (got_ev,) = outs
    assert got["final_step"] == want[0]["final_step"] == 1 and got["run"] == "cli-run"
    assert got["metrics"] == pytest.approx(want[0]["metrics"], abs=1e-6)
    assert got_ev["step"] == ev[0]["step"] == 1
    assert got_ev["eval_ce"] == pytest.approx(ev[0]["eval_ce"], abs=1e-6)


def test_serve_cli_tokens_equal_generate_on_the_broker_batches(capsys):
    res = serve_cli.main(["--arch", "stablelm-3b", "--variant", "smoke", "--device", "cpu",
                          "--requests", "5", "--batch-size", "2", "--max-prompt-len", "12",
                          "--max-new-tokens", "4", "--seed", "3"])
    out = capsys.readouterr().out
    assert "5 requests in 3 batches, 20 tokens" in out and "on cpu" in out
    reqs = {r["request_id"]: r for r in res["requests"]}
    assert [len(b) for b in res["batches"]] == [2, 2, 1]
    assert [rid for b in res["batches"] for rid in b] == [r["request_id"] for r in res["requests"]]
    engine = res["engine"]
    assert engine.cfg.param_dtype == "float32" and res["stats"]["batches"] == 3
    rcfg = ref_get_config("stablelm-3b", "smoke").copy(param_dtype="float32",
                                                       compute_dtype="float32")
    ref = RefEngine(rcfg, jax.tree.map(jnp.asarray, params_to_reference(engine.params)),
                    max_len=engine.max_len)
    for batch in res["batches"]:
        prompts = pad_prompts([reqs[rid] for rid in batch])
        got = [reqs[rid]["tokens"] for rid in batch]
        assert got == engine.generate(prompts, max_new_tokens=4).tolist()
        assert got == ref.generate(prompts, max_new_tokens=4).tolist()


def test_serve_cli_exits_when_a_batch_fails(capsys):
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--arch", "llama-3.2-vision-11b", "--variant", "smoke", "--device", "cpu",
                        "--requests", "2", "--batch-size", "2", "--max-prompt-len", "8",
                        "--max-new-tokens", "2"])
    assert e.value.code == 1
    assert time.perf_counter() - t0 < serve_cli.RESULT_TIMEOUT_S / 10
    err = capsys.readouterr().err
    assert "generate_batch failed" in err and "image_embeds" in err


def test_serve_cli_refuses_a_variant_too_big_for_float32(monkeypatch):
    card = 80 * 10**9
    monkeypatch.setattr(serve_cli, "device_memory", lambda dev: card)

    def no_build(*args, **kwargs):
        raise AssertionError("weights were built")

    monkeypatch.setattr(serve_cli, "ServeExecutor", no_build)
    need = 4 * count_params(model_spec(get_config("mixtral-8x7b", "half-depth")))
    assert need > card
    with pytest.raises(SystemExit, match=f"{need} bytes of float32 parameters"):
        serve_cli.main(["--arch", "mixtral-8x7b", "--variant", "half-depth", "--device", "cpu"])
