"""Parameter trees: nested dicts and lists of tensors, flattened in the
order ``jax.tree`` uses (dict keys sorted, lists in order), so that leaf
indices, and with them the bucket plan, match the JAX package's.  Anything
else, a tuple included (a shape), is a leaf.  ``FlatHost`` is a tree's
leaves as one float32 host vector, the PS trainers' view."""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

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


def _tensor(leaf) -> torch.Tensor:
    return leaf if torch.is_tensor(leaf) else torch.as_tensor(
        np.asarray(leaf))


class FlatHost:
    """The leaves of a tree like ``tree`` (tensors or arrays, in
    ``tree_leaves`` order) as one float32 vector on the host, and back:
    ``unflatten`` gives each leaf its shape, dtype and device again (an
    array leaf comes back as a CPU tensor), always in fresh memory."""

    def __init__(self, tree: Tree):
        leaves = [_tensor(l) for l in tree_leaves(tree)]
        self.like = tree
        self.shapes = [tuple(l.shape) for l in leaves]
        self.sizes = [int(l.numel()) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.devices = [l.device for l in leaves]

    def flatten(self, tree: Tree) -> np.ndarray:
        leaves = [_tensor(l).detach().reshape(-1) for l in tree_leaves(tree)]
        if len({l.device for l in leaves}) > 1:
            leaves = [l.cpu() for l in leaves]
        return torch.cat([l.to(torch.float32) for l in leaves]).cpu().numpy()

    def unflatten(self, flat: np.ndarray) -> Tree:
        src = torch.from_numpy(np.ascontiguousarray(flat, np.float32))
        one = len(set(self.devices)) == 1
        if one:
            src = src.to(self.devices[0], copy=True)
        out, off = [], 0
        for shape, n, dt, dev in zip(self.shapes, self.sizes, self.dtypes,
                                     self.devices):
            out.append(src[off:off + n].reshape(shape).to(
                device=dev, dtype=dt, copy=not one))
            off += n
        return tree_unflatten(self.like, out)
