"""The reference's main path on the port, on the CPU, through the
reference's ``CFSClient`` (the ``colony`` fixture): ``prepare_data`` ->
``train`` (a crash at step 3, then a resume from ``latest.json``) ->
``evaluate``, and the train→serve hand-off both ways: the port trains and
the reference's ``ServeEngine`` serves, and the reference's
``TrainerExecutor.train`` trains and the port serves; greedy tokens equal
the same framework's serving of the same parameters. Straight and
resumed runs agree at the reference's atol 1e-6
(``test_checkpoint_serve.py``); the two frameworks' evaluations of one
checkpoint at atol 1e-5."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core.fs import CFSClient, MemoryStorage
from repro.runtime.jax_executor import ServeExecutor, TrainerExecutor
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.interop import params_to_reference
from repro_torch.runtime import train_loop as tl
from repro_torch.runtime.store import MemoryStore
from repro_torch.serve.batcher import make_batch_handler, result_tokens
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import leaves_with_names

KW = dict(arch="stablelm-3b", steps=6, batch=2, seq_len=16, checkpoint_every=2, warmup_steps=2)
PROMPTS = np.random.default_rng(3).integers(0, 256, (2, 8)).astype(np.int32)


@pytest.fixture()
def cfs(colony):
    return CFSClient(colony["client"], MemoryStorage(), colony["colony_prv"])


def _params(store, run, optimizer="adamw"):
    """The run's latest params, as the port restores them."""
    like = tl._init_state(tl._smoke_cfg({"arch": "stablelm-3b"}),
                          tl.TrainConfig(optimizer=optimizer), torch.device("cpu"))
    state, _ = tl.CheckpointManager(store, "dev", run=run).restore_latest(like)
    return state["params"]


def test_continuum_prepare_train_crash_resume_evaluate(cfs):
    out = tl.prepare_data(cfs, "dev", shards=2, tokens_per_shard=64)
    assert out[0]["files"] == 2 and out[0]["snapshotid"]
    assert len(cfs.download_bytes("dev", "/datasets/synth", "shard-0001.bin")) == 64 * 4

    straight = tl.train(cfs, "dev", device="cpu", run="straight", **KW)
    assert straight[0]["final_step"] == 5 and straight[0]["run"] == "straight"
    assert set(straight[0]["metrics"]) == {"ce", "loss", "grad_norm", "lr"}

    with pytest.raises(tl.SimulatedCrash, match="step 3"):
        tl.train(cfs, "dev", device="cpu", run="crashed", die_at_step=3, **KW)
    ckpt = tl.CheckpointManager(cfs, "dev", run="crashed")
    assert ckpt.latest_step() == 1  # steps 0-2 ran; the last checkpoint is step 1's
    resumed = tl.train(cfs, "dev", device="cpu", run="crashed", **KW)  # resumes at step 2
    assert ckpt.latest_step() == 5
    for key, value in straight[0]["metrics"].items():
        assert resumed[0]["metrics"][key] == pytest.approx(value, abs=1e-6), key
    a, b = _params(cfs, "straight"), _params(cfs, "crashed")
    for (name, x), (_, y) in zip(leaves_with_names(a), leaves_with_names(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, err_msg=name)

    ev = tl.evaluate(cfs, "dev", device="cpu", arch="stablelm-3b", run="crashed", batch=2,
                     seq_len=16)
    assert ev[0]["step"] == 5 and ev[0]["run"] == "crashed" and np.isfinite(ev[0]["eval_ce"])
    with pytest.raises(RuntimeError, match="no checkpoint"):
        tl.evaluate(cfs, "dev", device="cpu", arch="stablelm-3b", run="never")


def test_port_trains_reference_serves(colony, cfs):
    tl.train(cfs, "dev", device="cpu", run="port-run", **KW)
    trained = _params(cfs, "port-run")
    # the reference's ServeExecutor restores the port's checkpoint
    ex = ServeExecutor(colony["client"], "dev", "serve-ref", "tpu-serve", cfs.storage,
                       colony_prvkey=colony["colony_prv"],
                       arch="stablelm-3b", max_len=32, run="port-run")
    for (name, x), (_, y) in zip(leaves_with_names(params_to_reference(trained)),
                                 jax.tree_util.tree_flatten_with_path(ex.engine.params)[0]):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)
    want = ServeEngine(tl._smoke_cfg({"arch": "stablelm-3b"}), trained, max_len=32,
                       device="cpu").generate(PROMPTS, max_new_tokens=6)
    np.testing.assert_array_equal(ex.engine.generate(PROMPTS, max_new_tokens=6), want)
    # and the port's own hand-off serves the same tokens through the batch handler
    engine = tl.serve_engine(cfs, "dev", arch="stablelm-3b", max_len=32, run="port-run",
                             device="cpu")
    handler = make_batch_handler(engine, cfs, "dev")
    requests = [{"request_id": f"r{i}", "prompt": PROMPTS[i].tolist(), "max_new_tokens": 6}
                for i in range(2)]
    assert handler(None, packed_args=requests) == [2]
    for i, r in enumerate(requests):
        assert result_tokens(cfs, "dev", r["request_id"]) == want[i].tolist()


def test_reference_trains_port_serves_and_evaluates(colony, cfs):
    ex = TrainerExecutor(colony["client"], "dev", "train-ref", "tpu-pod", cfs.storage,
                         colony_prvkey=colony["colony_prv"], prvkey=colony["colony_prv"])
    ex.train(None, run="ref-run", **KW)
    rserve = ServeExecutor(colony["client"], "dev", "serve-ref", "tpu-serve", cfs.storage,
                           colony_prvkey=colony["colony_prv"],
                           arch="stablelm-3b", max_len=32, run="ref-run")
    want = rserve.engine.generate(PROMPTS, max_new_tokens=6)
    engine = tl.serve_engine(cfs, "dev", arch="stablelm-3b", max_len=32, run="ref-run",
                             device="cpu")
    for (name, x), (_, y) in zip(leaves_with_names(params_to_reference(engine.params)),
                                 jax.tree_util.tree_flatten_with_path(rserve.engine.params)[0]):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=name)
    np.testing.assert_array_equal(engine.generate(PROMPTS, max_new_tokens=6), want)
    # the reference's engine on the same params, carried over through numpy
    same = RefServeEngine(rserve.engine.cfg, jax.tree.map(np.asarray, rserve.engine.params),
                          max_len=32)
    np.testing.assert_array_equal(same.generate(PROMPTS, max_new_tokens=6), want)
    # one checkpoint, two evaluations
    kw = dict(arch="stablelm-3b", run="ref-run", batch=2, seq_len=16)
    got = tl.evaluate(cfs, "dev", device="cpu", **kw)[0]
    ref = ex.evaluate(None, **kw)[0]
    assert got["step"] == ref["step"] == 5
    assert got["eval_ce"] == pytest.approx(ref["eval_ce"], abs=1e-5)


def test_train_resumes_an_adafactor_run_at_two_microbatches_and_evaluates_it(cfs):
    kw = dict(KW, optimizer="adafactor", microbatches=2, steps=4)
    tl.train(cfs, "dev", device="cpu", run="af", **kw)
    with pytest.raises(tl.SimulatedCrash):
        tl.train(cfs, "dev", device="cpu", run="af-crash", die_at_step=2, **kw)
    tl.train(cfs, "dev", device="cpu", run="af-crash", **kw)
    for (name, x), (_, y) in zip(leaves_with_names(_params(cfs, "af", "adafactor")),
                                 leaves_with_names(_params(cfs, "af-crash", "adafactor"))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, err_msg=name)
    ev = tl.evaluate(cfs, "dev", device="cpu", arch="stablelm-3b", optimizer="adafactor",
                     run="af", batch=2, seq_len=16)
    assert ev[0]["step"] == 3 and np.isfinite(ev[0]["eval_ce"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.train(MemoryStore(), "dev", arch="stablelm-3b", steps=1)


def test_launch_train_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import train as cli

    cli.main(["--arch", "stablelm-3b", "--steps", "3", "--batch", "2", "--seq-len", "16",
              "--checkpoint-every", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    decoder = json.JSONDecoder()  # two JSON documents: training's output, then evaluation's
    first, end = decoder.raw_decode(text)
    second, _ = decoder.raw_decode(text[end:].lstrip())
    assert first[0]["final_step"] == 2 and first[0]["run"] == "cli-run"
    assert second[0]["step"] == 2 and np.isfinite(second[0]["eval_ce"])
