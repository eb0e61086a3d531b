"""Training substrate of the port against the reference: the schedule,
clipping, cross-entropy, AdamW and Adafactor on small trees, the
reference's own contract tests (ported), and ``make_train_step`` on
stablelm smoke in float32 from the reference's params, for both
optimizers at 1 and 2 microbatches, against ``jax.jit(make_train_step)``.

Tolerances: the schedule, norms and CE at rtol 1e-6; optimizer trees at
atol 1e-6 / rtol 1e-5 after 5 updates; the train step's state (params,
moments) at atol 1e-5 / rtol 1e-4 and its metrics at atol 1e-5 after 3
steps (measured: at most 1.1e-6 apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import SyntheticTokens
from repro.train import optimizer as ropt
from repro.train.train_step import cross_entropy as ref_cross_entropy
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import params_from_reference, state_from_reference, state_to_reference
from repro_torch.models import init_params, model_spec
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    cross_entropy, init_state, loss_fn, make_eval_step, make_train_step, split_microbatches,
)
from repro_torch.tree import leaves, leaves_with_names, map_leaves


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


def _close_trees(got, want, atol, rtol):
    """``got`` (tensors) against ``want`` (jax arrays), leaf by leaf with names."""
    got = leaves_with_names(state_to_reference(got) if "step" in got else
                            {k: v for k, v in got.items()})
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (name, g), (_, w) in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# schedule, clipping, cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    kw = dict(learning_rate=1e-3, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 3, 5, 10, 37, 50, 99, 100, 150):
        want = float(ropt.lr_schedule(RefTrainConfig(**kw), jnp.int32(step)))
        got = float(opt.lr_schedule(TrainConfig(**kw), torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"a": (r.standard_normal(7) * scale).astype(np.float32),
            "blk": {"w": (r.standard_normal((3, 5)) * scale).astype(np.float32),
                    "s": (r.standard_normal((2, 4, 6)) * scale).astype(np.float32),
                    "col": (r.standard_normal((4, 1)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_global_norm_and_clipping_match_reference(max_norm):
    tree = _tree(0, scale=3.0)
    want, wnorm = ropt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    given = params_from_reference(tree)
    got, gnorm = opt.clip_by_global_norm(given, max_norm)
    assert float(gnorm) == pytest.approx(float(wnorm), rel=1e-6)
    assert all(a is b for a, b in zip(leaves(got), leaves(given)))  # scaled in place
    _close_trees(got, want, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_reference(with_mask):
    r = np.random.default_rng(1)
    logits = (r.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    targets = r.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (r.random((2, 5)) < 0.6).astype(np.float32) if with_mask else None
    want, wden = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                   None if mask is None else jnp.asarray(mask))
    got, gden = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                              None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(gden) == float(wden)


# ---------------------------------------------------------------------------
# optimizers on small trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference_over_steps(optimizer):
    """1-D, 2-D (factored), 3-D (factored over the last two) and a (4, 1)
    leaf (not factored), five updates from seeded gradients."""
    kw = dict(optimizer=optimizer, learning_rate=1e-2, warmup_steps=2, total_steps=20,
              weight_decay=0.1)
    rt, tt = RefTrainConfig(**kw), TrainConfig(**kw)
    params = _tree(2)
    rp = jax.tree.map(jnp.asarray, params)
    ro = ropt.opt_init(rp, rt)
    tp = params_from_reference(params)
    to = opt.opt_init(tp, tt)
    for step in range(5):
        grads = _tree(10 + step, scale=0.5)
        rp, ro = ropt.opt_update(rp, jax.tree.map(jnp.asarray, grads), ro, jnp.int32(step), rt)
        tp2, to2 = opt.opt_update(tp, params_from_reference(grads), to,
                                  torch.tensor(step, dtype=torch.int32), tt)
        # the results live in the given tensors
        assert all(a is b for a, b in zip(leaves(tp2), leaves(tp)))
        assert all(a is b for a, b in zip(leaves(to2), leaves(to)))
    _close_trees(tp, rp, atol=1e-6, rtol=1e-5)
    _close_trees(to, ro, atol=1e-6, rtol=1e-5)


def test_optimizer_state_keys_and_leaf_order_match_reference():
    params = _tree(3)
    rp = jax.tree.map(jnp.asarray, params)
    for name in ("adamw", "adafactor"):
        want = [jax.tree_util.keystr(p) for p, _ in
                jax.tree_util.tree_flatten_with_path(ropt.opt_init(rp, RefTrainConfig(optimizer=name)))[0]]
        got = [n for n, _ in leaves_with_names(
            opt.opt_init(params_from_reference(params), TrainConfig(optimizer=name)))]
        assert got == want


# ---------------------------------------------------------------------------
# the reference's contract tests (tests/test_train.py), ported
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=400, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.adamw_init(params)
    for step in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw w^2
        params, state = opt.adamw_update(params, grads, state,
                                         torch.tensor(step, dtype=torch.int32), tcfg)
    assert float(params["w"].abs().max()) < 0.5


def test_adafactor_minimizes_quadratic_matrix():
    tcfg = TrainConfig(optimizer="adafactor", learning_rate=0.3, warmup_steps=0,
                       total_steps=200, weight_decay=0.0)
    params = {"w": torch.ones((4, 8)) * 3.0}
    state = opt.adafactor_init(params)
    for step in range(150):
        grads = {"w": 2 * params["w"]}
        params, state = opt.adafactor_update(params, grads, state,
                                             torch.tensor(step, dtype=torch.int32), tcfg)
    assert float(params["w"].abs().max()) < 0.5


def test_adafactor_state_is_factored():
    state = opt.adafactor_init({"w": torch.zeros((16, 32)), "b": torch.zeros((16,))})
    assert state["v"]["w"]["vr"].shape == (16,)
    assert state["v"]["w"]["vc"].shape == (32,)
    assert state["v"]["b"]["v"].shape == (16,)  # vectors not factored


def test_lr_schedule_warmup_and_decay():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)

    def lr(step):
        return float(opt.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32)))

    assert lr(0) == 0.0
    assert abs(lr(10) - 1e-3) < 1e-9
    assert lr(5) == pytest.approx(5e-4)
    assert lr(100) == pytest.approx(1e-4, rel=0.01)


def test_grad_clip():
    clipped, norm = opt.clip_by_global_norm({"a": torch.ones(4) * 10.0}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)


def test_cross_entropy_uniform():
    ce, _ = cross_entropy(torch.zeros((2, 3, 7)), torch.zeros((2, 3), dtype=torch.int32))
    assert float(ce) == pytest.approx(np.log(7), rel=1e-5)


@pytest.fixture(scope="module")
def smoke():
    """stablelm smoke in float32: the reference's config and params, and
    the port's config (params carried over per test, through numpy)."""
    rcfg = _f32(ref_get_config("stablelm-3b", "smoke"))
    rparams = R.init_params(jax.random.key(0), R.model_spec(rcfg), jnp.float32)
    return rcfg, rparams, _f32(get_config("stablelm-3b", "smoke"))


def test_microbatch_matches_full_batch(smoke):
    """Pre-split accumulation over k microbatches == one full batch step."""
    _, _, cfg = smoke
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, grad_clip=0.0)
    tcfg1, tcfg2 = TrainConfig(microbatches=1, **kw), TrainConfig(microbatches=2, **kw)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    params2 = map_leaves(torch.clone, params)  # the first step updates ``params`` in place
    host = SyntheticTokens(cfg, 4, 16, seed=1).batch_at(0)
    s1, m1 = make_train_step(cfg, tcfg1)(init_state(params, tcfg1),
                                         {k: torch.from_numpy(v) for k, v in host.items()})
    split = {k: torch.from_numpy(v) for k, v in split_microbatches(host, 2).items()}
    s2, m2 = make_train_step(cfg, tcfg2)(init_state(params2, tcfg2), split)
    assert float(m1["ce"]) == pytest.approx(float(m2["ce"]), rel=1e-5)
    d = [float((a - b).abs().max()) for (_, a), (_, b) in
         zip(leaves_with_names(s1["params"]), leaves_with_names(s2["params"]))]
    assert max(d) < 1e-5


def test_loss_decreases_over_steps(smoke):
    """The whole stack learns the synthetic stream (loss drops)."""
    _, _, cfg = smoke
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=30)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    state = init_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    data = SyntheticTokens(cfg, 8, 32, seed=0)
    losses = []
    for i in range(30):
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()})
        losses.append(float(metrics["ce"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses
    assert int(state["step"]) == 30 and state["step"].dtype == torch.int32


def test_moe_and_mtp_raise_with_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="A10"):
        loss_fn({}, ModelConfig(moe=ModelConfig().moe.__class__(num_experts=4)), TrainConfig(),
                {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="A13"):
        make_train_step(ModelConfig(mtp_depth=1), TrainConfig())


def test_microbatched_step_refuses_an_unsplit_batch(smoke):
    _, _, cfg = smoke
    tcfg = TrainConfig(microbatches=2)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0), torch.float32, "cpu")
    host = SyntheticTokens(cfg, 4, 16, seed=1).batch_at(0)
    with pytest.raises(ValueError, match="pre-split"):
        make_train_step(cfg, tcfg)(init_state(params, tcfg),
                                   {k: torch.from_numpy(v) for k, v in host.items()})


# ---------------------------------------------------------------------------
# the train step against jax.jit(make_train_step)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_over_three_steps(smoke, optimizer, microbatches):
    rcfg, rparams, cfg = smoke
    kw = dict(optimizer=optimizer, learning_rate=1e-3, warmup_steps=1, total_steps=10,
              microbatches=microbatches)
    rt, tt = RefTrainConfig(**kw), TrainConfig(**kw)
    rstate = ref_init_state(rparams, rt)
    state = state_from_reference(jax.tree.map(np.asarray, rstate))
    ref_step = jax.jit(ref_make_train_step(rcfg, rt))
    step = make_train_step(cfg, tt)
    data = SyntheticTokens(rcfg, 4, 16, seed=1)
    for i in range(3):
        host = data.batch_at(i)
        if microbatches > 1:
            host = split_microbatches(host, microbatches)
        rstate, rmetrics = ref_step(rstate, {k: jnp.asarray(v) for k, v in host.items()})
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in host.items()})
        assert sorted(metrics) == sorted(rmetrics)
        for key in rmetrics:
            assert float(metrics[key]) == pytest.approx(float(rmetrics[key]), abs=1e-5), key
    assert state["step"].dtype == torch.int32 and int(state["step"]) == int(rstate["step"]) == 3
    _close_trees(state, rstate, atol=1e-5, rtol=1e-4)


def test_eval_step_matches_reference(smoke):
    from repro.train.train_step import make_eval_step as ref_make_eval_step

    rcfg, rparams, cfg = smoke
    params = params_from_reference(jax.tree.map(np.asarray, rparams))
    host = SyntheticTokens(rcfg, 2, 16, seed=9999).batch_at(0)
    want = ref_make_eval_step(rcfg, RefTrainConfig())(rparams, {"tokens": jnp.asarray(host["tokens"])})
    got = make_eval_step(cfg, TrainConfig())(params, {"tokens": torch.from_numpy(host["tokens"])})
    assert sorted(got) == sorted(want)
    assert float(got["ce"]) == pytest.approx(float(want["ce"]), abs=1e-5)
