"""The port's tree helpers against ``jax.tree_util`` on the same tree, and
their leaves' lifetime: a leaf is freed as soon as the last reference to it
goes, without the cyclic garbage collector (a train state held until the
collector runs can exhaust the card)."""

from __future__ import annotations

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro_torch.tree import leaves_with_names, rebuild


def _tree() -> dict:
    rng = np.random.default_rng(0)
    return {"groups": {"b1": {"w": rng.normal(size=(2, 3)), "b": rng.normal(size=3)},
                       "b0": {"wq": rng.normal(size=(4,))}},
            "embed": rng.normal(size=(5, 2)), "memory": None}


def _to_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def test_names_and_order_equal_jax_keystr_flatten():
    tree = _tree()
    want = [(jax.tree_util.keystr(path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = leaves_with_names(_to_torch(tree))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_rebuild_equals_jax_unflatten():
    tree = _tree()
    new = [np.full(np.shape(x), i, np.float64) for i, x in enumerate(jax.tree.leaves(tree))]
    want = jax.tree.unflatten(jax.tree.structure(tree), new)
    got = rebuild(_to_torch(tree), [torch.from_numpy(x) for x in new])
    assert [n for n, _ in leaves_with_names(got)] == [
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for (_, g), w in zip(leaves_with_names(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="more leaves"):
        rebuild(_to_torch(tree), [torch.zeros(1)] * (len(new) + 1))


@pytest.mark.parametrize("helper", ["leaves_with_names", "rebuild"])
def test_leaves_are_freed_without_the_cyclic_collector(helper):
    gc.collect()
    gc.disable()
    try:
        tree = _to_torch(_tree())
        if helper == "leaves_with_names":
            ref = weakref.ref(tree["groups"]["b1"]["w"])
            named = leaves_with_names(tree)
            del named, tree
        else:
            new = [torch.zeros(3) for _ in leaves_with_names(tree)]
            ref = weakref.ref(new[0])
            out = rebuild(tree, new)
            del out, new
        assert ref() is None, f"{helper} keeps its leaves alive until gc.collect()"
    finally:
        gc.enable()
