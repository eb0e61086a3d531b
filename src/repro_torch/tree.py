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


def leaves(tree: Any) -> list[Any]:
    """The leaves in flatten order (``jax.tree.leaves``)."""
    return [leaf for _, leaf in leaves_with_names(tree)]


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


def rebuild(tree: Any, leaves: list[Any]) -> Any:
    """``tree``'s dict structure with its leaves replaced, in flatten
    order, by ``leaves`` (``jax.tree.unflatten`` of ``tree``'s treedef)."""
    it = iter(leaves)

    def walk(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    out = walk(tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out
