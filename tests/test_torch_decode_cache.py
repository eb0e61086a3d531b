"""The port's ``decode_step`` writes the cache it is given (ROADMAP C21).

The reference's ``decode_step`` is pure: it returns a new cache and leaves
its argument as it was. The port's updates the stacked cache in place and
returns the very object it was given, which a decode step captured in a
CUDA graph needs. So two decode steps from one prefill cache at the same
position read different states: the second sees the first's update. A
caller that branches two decodes off one cache clones it first with
``map_leaves(torch.clone, cache)``; then both branches give the
reference's logits. rwkv6-7b's smoke config in float32 shows it, since
its recurrent state changes with every token (rewriting one K/V slot
twice would not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as ref_get_config
from repro_torch.configs import get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import decode_step, prefill
from repro_torch.tree import leaves_with_names, map_leaves

ARCH = "rwkv6-7b"
B, S = 2, 12
ATOL, RTOL = 5e-3, 1e-3  # model-level bar of tests/test_kernels.py


def _f32(cfg):
    return cfg.copy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def model():
    """(reference cfg and params, port cfg and params, prompt and next token)."""
    rcfg = _f32(ref_get_config(ARCH, "smoke"))
    np_tree = jax.tree.map(np.asarray, R.init_params(jax.random.key(0), R.model_spec(rcfg),
                                                     jnp.float32))
    cfg = _f32(get_config(ARCH, "smoke"))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return (rcfg, jax.tree.map(jnp.asarray, np_tree), cfg, params_from_reference(np_tree, "cpu"),
            tokens)


def _prefill(model):
    _, _, cfg, params, tokens = model
    _, cache = prefill(params, cfg, {"tokens": torch.from_numpy(tokens[:, :S])}, max_len=S + 4)
    return cache


def test_decode_step_returns_the_cache_it_was_given(model):
    _, _, cfg, params, tokens = model
    cache = _prefill(model)
    before = map_leaves(torch.clone, cache)
    _, out = decode_step(params, cfg, torch.from_numpy(tokens[:, S:]), cache, S)
    assert out is cache
    changed = [name for (name, a), (_, b) in zip(leaves_with_names(cache),
                                                  leaves_with_names(before))
               if not torch.equal(a, b)]
    assert changed  # written in place: the argument no longer holds the prefill's state


def test_two_decodes_from_one_cache_differ_unless_the_caller_clones_it(model):
    rcfg, rparams, cfg, params, tokens = model
    tok = torch.from_numpy(tokens[:, S:])
    rt = jnp.asarray(tokens)
    _, rcache = R.prefill(rparams, rcfg, {"tokens": rt[:, :S]}, max_len=S + 4)
    ref = [np.asarray(R.decode_step(rparams, rcfg, rt[:, S:], rcache, jnp.int32(S))[0])
           for _ in range(2)]
    np.testing.assert_array_equal(ref[0], ref[1])  # the reference's step is pure

    shared = _prefill(model)
    first, _ = decode_step(params, cfg, tok, shared, S)
    second, _ = decode_step(params, cfg, tok, shared, S)  # reads the first step's state
    assert (first - second).abs().max().item() > 1e-2

    cache = _prefill(model)
    branches = [decode_step(params, cfg, tok, map_leaves(torch.clone, cache), S)[0]
                for _ in range(2)]
    assert torch.equal(branches[0], branches[1])
    np.testing.assert_allclose(first.numpy(), ref[0], atol=ATOL, rtol=RTOL)
    for logits in branches:
        np.testing.assert_allclose(logits.numpy(), ref[0], atol=ATOL, rtol=RTOL)
