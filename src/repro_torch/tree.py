"""Nested-dict trees in the reference's flatten order.

``jax.tree.flatten`` visits dict keys in sorted order, and checkpoint
manifests name each leaf by ``jax.tree_util.keystr`` of its path, e.g.
``['groups']['b0']['mixer']['wq']``. These helpers reproduce both without
JAX, so leaf ``i`` here is leaf ``i`` there.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves_with_names(tree: Any, is_leaf: Callable[[Any], bool] | None = None) -> list[tuple[str, Any]]:
    """(keystr path, leaf) pairs in sorted-key order. ``None`` subtrees
    are empty, as in JAX."""
    out: list[tuple[str, Any]] = []

    def walk(node: Any, path: str) -> None:
        if node is None:
            return
        if isinstance(node, dict) and not (is_leaf and is_leaf(node)):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
            return
        out.append((path, node))

    walk(tree, "")
    return out


def map_leaves(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every non-dict leaf, keeping the dict structure.

    With more trees of the same structure, ``fn`` takes the leaves at one
    path from each, as ``jax.tree.map`` does.
    """
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
