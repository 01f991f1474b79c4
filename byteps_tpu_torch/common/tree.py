"""Parameter trees: nested dicts and lists of tensors, flattened in the
order ``jax.tree`` uses (dict keys sorted, lists in order), so that leaf
indices, and with them the bucket plan, match the JAX package's.  Anything
else, a tuple included (a shape), is a leaf."""

from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def tree_leaves(tree: Tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """Rebuild a tree shaped like ``like`` from leaves in tree_leaves order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, list):
            return [build(sub) for sub in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*args) for args in
                                 zip(tree_leaves(tree), *others)])


def tree_paths(tree: Tree, prefix: str = "") -> List[str]:
    """Each leaf's path in tree_leaves order, written as ``jax.tree_util.
    keystr`` writes it: ``['key']`` for a dict entry, ``[0]`` for a list
    item."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in tree_paths(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, list):
        return [p for i, sub in enumerate(tree)
                for p in tree_paths(sub, f"{prefix}[{i}]")]
    return [prefix]
