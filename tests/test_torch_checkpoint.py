"""CFS checkpoints of the port against the reference's, through the
reference's ``CFSClient`` (the ``colony`` fixture): a torch save restores
in the reference's ``CheckpointManager`` and the reverse, bit for bit,
with equal leaf names in ``manifest.json``; the ``latest.json`` pointer,
async saves, the refusal of bfloat16 leaves (ROADMAP C1), and the
reference's resume-equivalence test (train 4 steps == train 2,
checkpoint, restore, train 2, at its atol 1e-6), ported."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.core.fs import CFSClient, MemoryStorage
from repro.data.pipeline import SyntheticTokens
from repro.train.checkpoint import CheckpointManager as RefManager
from repro.train.train_step import init_state as ref_init_state
from repro_torch.configs import TrainConfig, get_config
from repro_torch.interop import state_to_reference
from repro_torch.models import init_params, model_spec
from repro_torch.runtime.store import MemoryStore
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import init_state, make_train_step
from repro_torch.tree import leaves_with_names, map_leaves


@pytest.fixture()
def cfs(colony):
    return CFSClient(colony["client"], MemoryStorage(), colony["colony_prv"])


def _cfg():
    return get_config("stablelm-3b", "smoke").copy(param_dtype="float32", compute_dtype="float32")


def _state(seed=0, optimizer="adamw"):
    tcfg = TrainConfig(total_steps=10, optimizer=optimizer)
    params = init_params(model_spec(_cfg()), torch.Generator().manual_seed(seed), torch.float32,
                         "cpu")
    return tcfg, init_state(params, tcfg)


def _ref_state(optimizer="adamw", seed=0):
    rcfg = ref_get_config("stablelm-3b", "smoke").copy(param_dtype="float32",
                                                       compute_dtype="float32")
    params = R.init_params(jax.random.key(seed), R.model_spec(rcfg), jnp.float32)
    return ref_init_state(params, RefTrainConfig(total_steps=10, optimizer=optimizer))


def _assert_equal_trees(got, want):
    got, want = leaves_with_names(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (name, g), (_, w) in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_torch_save_restores_in_the_reference(cfs, optimizer):
    _, state = _state(optimizer=optimizer)
    state["step"] = torch.tensor(3, dtype=torch.int32)
    CheckpointManager(cfs, "dev", run=f"t2r-{optimizer}").save(state, step=3)
    restored, step = RefManager(cfs, "dev", run=f"t2r-{optimizer}").restore_latest(
        _ref_state(optimizer))
    assert step == 3 and int(restored["step"]) == 3
    _assert_equal_trees(state_to_reference(state), restored)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_reference_save_restores_in_torch(cfs, optimizer):
    rstate = dict(_ref_state(optimizer, seed=1), step=jnp.int32(7))
    RefManager(cfs, "dev", run=f"r2t-{optimizer}").save(rstate, step=7)
    _, like = _state(optimizer=optimizer)
    restored, step = CheckpointManager(cfs, "dev", run=f"r2t-{optimizer}").restore_latest(like)
    assert step == 7 and restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    _assert_equal_trees(restored, rstate)


def test_manifests_name_the_same_leaves(cfs):
    _, state = _state()
    CheckpointManager(cfs, "dev", run="m-torch").save(state, step=0)
    RefManager(cfs, "dev", run="m-ref").save(_ref_state(), step=0)
    got, want = (json.loads(cfs.download_bytes("dev", f"/checkpoints/{run}/step-0", "manifest.json"))
                 for run in ("m-torch", "m-ref"))
    assert got["step"] == want["step"] == 0
    assert got["leaves"] == want["leaves"]  # names, files, shapes and dtypes
    assert got["leaves"][0]["name"].startswith("['opt']") and got["leaves"][-1]["name"] == "['step']"


def test_checkpoint_roundtrip_and_latest_pointer_advances(cfs):
    _, state = _state()
    mgr = CheckpointManager(cfs, "dev", run="t1")
    assert mgr.latest_step() is None and mgr.restore_latest(state) is None
    mgr.save(state, step=1)
    state2 = dict(state, step=torch.tensor(2, dtype=torch.int32))
    mgr.save(state2, step=2)
    restored, step = mgr.restore_latest(state)
    assert step == 2 and int(restored["step"]) == 2
    old = mgr.restore(1, state)  # the older checkpoint stays restorable (immutability)
    assert int(old["step"]) == 0
    for (_, a), (_, b) in zip(leaves_with_names(state), leaves_with_names(old)):
        assert torch.equal(a, b)
    pointer = json.loads(cfs.download_bytes("dev", "/checkpoints/t1", "latest.json"))
    assert pointer["step"] == 2 and pointer["snapshotid"]


def test_checkpoint_async_and_wait(cfs):
    _, state = _state()
    mgr = CheckpointManager(cfs, "dev", run="t3")
    assert mgr.save(state, step=5, async_=True) is None
    # the leaves were copied before save returned: changing the state now
    # does not change the checkpoint
    for _, leaf in leaves_with_names(state["params"]):
        leaf.add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    restored = mgr.restore(5, state)
    _, fresh = _state()
    for (_, a), (_, b) in zip(leaves_with_names(fresh), leaves_with_names(restored)):
        assert torch.equal(a, b)


def test_async_save_error_surfaces_in_wait():
    class Broken(MemoryStore):
        def upload_bytes(self, *a, **kw):
            raise OSError("disk gone")

    _, state = _state()
    mgr = CheckpointManager(Broken(), "dev", run="t5")
    mgr.save(state, step=1, async_=True)
    with pytest.raises(OSError, match="disk gone"):
        mgr.wait()
    mgr.wait()  # the error is raised once


def test_bf16_leaves_are_refused(cfs):
    _, state = _state()
    state["params"]["embed"] = state["params"]["embed"].bfloat16()
    with pytest.raises(ValueError, match="bfloat16.*C1"):
        CheckpointManager(cfs, "dev", run="t6").save(state, step=0)


def test_restore_refuses_a_changed_structure(cfs):
    _, state = _state()
    mgr = CheckpointManager(MemoryStore(), "dev", run="t7")
    mgr.save(state, step=0)
    _, other = _state(optimizer="adafactor")
    with pytest.raises(ValueError, match="structure changed|expected"):
        mgr.restore(0, other)


def test_checkpoint_resume_training_is_equivalent(cfs):
    """Train 4 steps straight == train 2, checkpoint, restore, train 2."""
    tcfg, state = _state()
    cfg = _cfg()
    step_fn = make_train_step(cfg, tcfg)
    data = SyntheticTokens(cfg, 4, 16, seed=0)

    def run(state, start, n):
        for i in range(start, start + n):
            state, _ = step_fn(state, {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()})
        return state

    straight = run(map_leaves(torch.clone, state), 0, 4)  # a step updates its state in place
    mgr = CheckpointManager(cfs, "dev", run="t4")
    half = run(state, 0, 2)
    mgr.save(half, step=1)
    resumed, _ = mgr.restore_latest(half)
    resumed = run(resumed, 2, 2)
    for (name, a), (_, b) in zip(leaves_with_names(straight), leaves_with_names(resumed)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=name)


def test_memory_store_holds_what_the_manager_needs():
    store = MemoryStore()
    _, state = _state()
    mgr = CheckpointManager(store, "dev", run="mem")
    snap = mgr.save(state, step=4)
    assert snap["snapshotid"] in store.snapshots
    assert "manifest.json" in store.snapshots[snap["snapshotid"]]["files"]
    restored, step = mgr.restore_latest(state)
    assert step == 4
    with pytest.raises(FileNotFoundError):
        store.download_bytes("dev", "/nowhere", "x")
