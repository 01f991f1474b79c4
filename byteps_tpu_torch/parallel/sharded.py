"""Sharded training on DTensor: parameters, gradients and optimizer state
laid out over a named mesh by PartitionSpecs.

Counterpart of ``byteps_tpu/parallel/sharded.py``.  The JAX package
annotates parameter and batch shardings and lets GSPMD insert the
collectives.  Here the same specs become ``torch.distributed.tensor``
placements on a ``DeviceMesh`` (``parallel/mesh.py::make_mesh``), and
DTensor's sharding propagation plays GSPMD's part: the user's ``loss_fn``
is written on global shapes, a batch split over ``dp`` against replicated
parameters gives gradients that are pending sums (``Partial``) over
``dp``, which the step redistributes to each parameter's own placement
(an all-reduce; a reduce-scatter for a sharded one).  TP comes from
Megatron column/row specs (``models/transformer.py::param_specs``).

  - ZeRO-1 (``zero1=True``): the optimizer runs over dp shards of the
    parameters (``zero1_init``), so Adam's moments exist 1/dp per rank;
    the step reduce-scatters each gradient onto its shard, updates the
    shard, and all-gathers it back into the replicated parameter.
  - FSDP (``fsdp_param_specs``): the parameters themselves are stored
    split over ``dp``; the step gathers them for the loss (an all-gather
    whose backward reduce-scatters the gradient) and the optimizer, built
    over the stored shards (``fsdp_init``), updates 1/dp of each.

optax's ``(init, update)`` pair has no torch counterpart: ``zero1_init`` and
``fsdp_init`` take ``make_optimizer(leaves) -> torch.optim.Optimizer`` and
return the optimizer, whose state is born from the sharded leaves, and the
step is ``step(params, batch) -> loss``, updating in place as
``parallel/data_parallel.py::build_train_step`` does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from ..common.device import is_dtensor
from ..common.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (the
    dim split over several axes, major first), or None (not split).
    Missing trailing entries are None.  The JAX ``PartitionSpec``'s
    shape, without JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(_axis_names(mesh).index(axis))


_DMESH = {}


def dtensor_mesh(mesh):
    """The sub-mesh the DTensors live on: ``mesh``'s axes larger than one
    (in a world of one, its first axis).  A size-1 axis splits nothing,
    and DTensor's sharding propagation enumerates placements over every
    mesh dim: on the five-axis mesh of ``make_mesh`` the first step of a
    small model spent minutes there, on the sub-mesh a second."""
    key = id(mesh)
    if key not in _DMESH:
        names = _axis_names(mesh)
        keep = tuple(a for a in names if _axis_size(mesh, a) > 1)
        _DMESH[key] = (mesh, mesh[keep or names[:1]])
    return _DMESH[key][1]


def spec_placements(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec`` on ``dtensor_mesh(mesh)``, one
    per dim of it: Shard(d) on each axis that splits tensor dim d,
    Replicate elsewhere.  Every axis the spec names must be ``mesh``'s."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    kept = _axis_names(dtensor_mesh(mesh))
    out = [Replicate()] * len(kept)
    used = set()
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec} names {a!r}, not a mesh axis "
                                 f"(mesh axes: {names})")
            if a in used:
                raise ValueError(f"{spec} uses axis {a!r} twice")
            used.add(a)
            if a in kept:
                out[kept.index(a)] = Shard(dim)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            # DTensor splits a dim over several mesh dims in mesh order.
            raise ValueError(f"{spec}: the axes {axes} of dim {dim} must "
                             f"follow the mesh's order {names}")
    return tuple(out)


def make_param_shardings(mesh, specs: Tree) -> Tree:
    """The specs tree as a tree of DTensor placements on
    ``dtensor_mesh(mesh)``."""
    return tree_map(lambda s: spec_placements(mesh, s), specs)


def shard_params(params: Tree, mesh, specs: Tree) -> Tree:
    """Place a param tree onto the mesh under ``specs`` (PartitionSpec tree
    with the same structure): each leaf becomes a DTensor leaf with the
    spec's placements, rank 0's values scattered to every rank, and keeps
    its ``requires_grad``."""
    from torch.distributed.tensor import distribute_tensor

    def put(p, pl):
        t = p.detach()
        if is_dtensor(t):
            t = t.redistribute(placements=pl)
        else:
            t = distribute_tensor(t, dtensor_mesh(mesh), pl)
        return t.requires_grad_(p.requires_grad)
    return tree_map(put, params, make_param_shardings(mesh, specs))


def init_sharded(init_fn: Callable[[], Tree], mesh, specs: Tree) -> Tree:
    """``shard_params(init_fn(), mesh, specs)``: ``init_fn`` builds the
    whole tree on each rank, which then keeps rank 0's blocks.  (The JAX
    version creates each block in place under jit; here the whole leaf
    exists until it is placed.)"""
    return shard_params(init_fn(), mesh, specs)


def opt_state_specs(optimizer: Any, params: Tree, specs: Tree) -> Tree:
    """PartitionSpecs of the optimizer state, one per parameter leaf.

    A torch optimizer keeps its state per parameter, created from it
    (``zeros_like``), so each leaf's state (Adam's moments, momentum
    buffers) follows its parameter's spec: the tree is ``specs`` itself.
    This replaces the JAX package's match of state paths to parameter
    paths by suffix; scalars such as the step count are not in the tree.
    ``optimizer`` is accepted for parity and unused."""
    del optimizer
    if len(tree_leaves(specs)) != len(tree_leaves(params)):
        raise ValueError("specs and params differ in structure")
    return specs


def zero1_opt_specs(optimizer: Any, params: Tree, mesh, param_specs: Tree,
                    dp_axis: str = "dp",
                    min_shard_elems: int = 1024) -> Tree:
    """ZeRO-1 PartitionSpecs: optimizer state sharded over the dp axis.

    Plain DP replicates the optimizer state on every rank, 8 bytes a
    parameter of float32 Adam moments; ZeRO-1 (weight-update sharding)
    stores 1/dp of each moment per rank instead: each leaf's state spec
    (``opt_state_specs``) gains the dp axis on its first not-yet-sharded,
    dp-divisible dimension, and the update runs on that shard, turning the
    DP all-reduce into a reduce-scatter and an all-gather.

    Leaves smaller than ``min_shard_elems`` and leaves with no dp-divisible
    free axis keep their parameter's spec.  On a mesh without ``dp_axis``
    this raises (hierarchical meshes name their data axes
    'ici_dp'/'dcn_dp'); an axis of size 1 is a valid no-op.  The result
    is a tree shaped like ``params``.
    """
    _check_axis(mesh, dp_axis, "zero1")
    base = opt_state_specs(optimizer, params, param_specs)
    return _shard_free_axis(base, params, mesh, dp_axis, min_shard_elems)


def _check_axis(mesh, axis: str, who: str) -> None:
    """Raise on a mesh without the named axis — silently no-opping would
    replicate the very tensors the caller asked to shard (hierarchical
    meshes name their data axes 'ici_dp'/'dcn_dp', not 'dp')."""
    names = _axis_names(mesh)
    if axis not in names:
        raise ValueError(
            f"{who} dp_axis={axis!r} is not a mesh axis "
            f"(mesh axes: {names}); on a hierarchical mesh "
            f"pass the data axis explicitly, e.g. dp_axis='ici_dp'")


def _shard_free_axis(specs: Tree, shapes: Tree, mesh, dp_axis: str,
                     min_shard_elems: int) -> Tree:
    """Upgrade each spec with ``dp_axis`` on its leaf's first unsharded,
    dp-divisible dimension; leaves already using the axis, scalars, and
    leaves under ``min_shard_elems`` pass through unchanged.  A leaf of
    ``shapes`` is a shape or anything with one (global, for a DTensor)."""
    dp = _axis_size(mesh, dp_axis)
    if dp <= 1:
        return specs

    def upgrade(spec: PartitionSpec, leaf) -> PartitionSpec:
        shape = tuple(getattr(leaf, "shape", leaf))
        if not shape or math.prod(shape) < min_shard_elems:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if any(dp_axis in _entry_axes(e) for e in entries):
            return spec
        for ax, size in enumerate(shape):
            if entries[ax] is None and size % dp == 0:
                entries[ax] = dp_axis
                return P(*entries)
        return spec

    return tree_map(upgrade, specs, shapes)


def fsdp_param_specs(params: Tree, mesh, base_specs: Optional[Tree] = None,
                     dp_axis: str = "dp",
                     min_shard_elems: int = 1024) -> Tree:
    """FSDP (ZeRO-3-style) PartitionSpecs: parameters themselves sharded
    over the dp axis.

    Each leaf of ``base_specs`` (default all-replicated; pass
    ``models.transformer.param_specs(cfg)`` to compose with TP) gains the
    dp axis on a dimension it leaves free; tiny leaves (< ``min_shard_elems``)
    stay as they are.  Place the params with ``shard_params``, build the
    optimizer with ``fsdp_init`` and step with
    ``build_sharded_train_step(loss_fn, opt, mesh, fsdp_specs)``: params,
    gradients and moments then live 1/dp per rank between steps.
    """
    _check_axis(mesh, dp_axis, "fsdp")
    if base_specs is None:
        base_specs = tree_map(lambda _: P(), params)
    return _shard_free_axis(base_specs, params, mesh, dp_axis,
                            min_shard_elems)


def zero1_init(make_optimizer: Callable[[list], torch.optim.Optimizer],
               params: Tree, mesh, param_specs: Tree,
               dp_axis: str = "dp",
               opt_specs: Optional[Tree] = None) -> torch.optim.Optimizer:
    """The optimizer of a ZeRO-1 step, its state born in the dp-sharded
    layout: ``make_optimizer`` gets, in ``tree_leaves`` order, each
    parameter's dp shard (``zero1_opt_specs``) or, for a leaf that stays
    whole, the parameter itself, so the moments it creates never exist
    whole.  The step keeps the shards and the params equal.  Pair
    with ``build_sharded_train_step(..., zero1=True, params=params)``;
    pass ``opt_specs`` (also the step's ``zero1_specs=``) to skip the
    derivation.  ``params`` are ``shard_params``' DTensors."""
    if opt_specs is None:
        opt_specs = zero1_opt_specs(make_optimizer, params, mesh,
                                    param_specs, dp_axis=dp_axis)
    shards = []
    for p, pl in zip(tree_leaves(params),
                     tree_leaves(make_param_shardings(mesh, opt_specs))):
        _check_placed(p, "zero1_init")
        if tuple(p.placements) == pl:
            shards.append(p)
        else:
            shards.append(p.detach().redistribute(placements=pl)
                          .requires_grad_())
    return make_optimizer(shards)


def fsdp_init(make_optimizer: Callable[[list], torch.optim.Optimizer],
              params: Tree, mesh, fsdp_specs: Tree) -> torch.optim.Optimizer:
    """The optimizer of an FSDP step, over the params as ``shard_params``
    placed them under ``fsdp_specs``, so its state is born in their
    layout: 1/dp per rank."""
    for p, pl in zip(tree_leaves(params),
                     tree_leaves(make_param_shardings(mesh, fsdp_specs))):
        _check_placed(p, "fsdp_init", pl)
    return make_optimizer(tree_leaves(params))


def _check_placed(p, who: str, placements=None) -> None:
    if not is_dtensor(p) or (placements is not None
                             and tuple(p.placements) != placements):
        raise ValueError(
            f"{who}: params must be DTensors placed by shard_params(params, "
            f"mesh, specs) under the step's specs; got "
            f"{getattr(p, 'placements', type(p).__name__)}"
            + ("" if placements is None else f", want {placements}"))


def _batch_leaves(tree) -> list:
    """A batch's leaves: tuples and lists are containers here (the
    param trees of ``common.tree`` keep them as leaves)."""
    if isinstance(tree, (tuple, list)) and not _is_spec(tree):
        return [x for sub in tree for x in _batch_leaves(sub)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _batch_leaves(tree[k])]
    return [tree]


def _batch_axes(batch_spec: Tree) -> set:
    return {a for s in _batch_leaves(batch_spec) for e in s
            for a in _entry_axes(e)}


def _place_batch(batch: Tree, mesh, batch_spec: Tree) -> Tree:
    """Each rank passes the same global batch and keeps its block (no
    communication); DTensors are redistributed to the spec.  One spec
    places every leaf, or ``batch_spec`` is a tree shaped like ``batch``."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, spec):
        if isinstance(x, (tuple, list)):
            specs = [spec] * len(x) if _is_spec(spec) else spec
            return type(x)(put(a, sp) for a, sp in zip(x, specs))
        if isinstance(x, dict):
            return {k: put(v, spec if _is_spec(spec) else spec[k])
                    for k, v in x.items()}
        pl = spec_placements(mesh, spec)
        if is_dtensor(x):
            return x.redistribute(placements=pl)
        return distribute_tensor(x, dtensor_mesh(mesh), pl,
                                 src_data_rank=None)
    return put(batch, batch_spec)


def build_sharded_train_step(
    loss_fn: Callable[[Tree, Any], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    mesh,
    param_specs: Tree,
    batch_spec: Tree = P("dp"),
    zero1: bool = False,
    params: Optional[Tree] = None,
    zero1_axis: str = "dp",
    zero1_specs: Optional[Tree] = None,
) -> Callable:
    """``step(params, batch) -> loss`` under DTensor sharding: ``params``
    are ``shard_params(params, mesh, param_specs)``'s DTensors, updated in
    place; ``batch`` is the global batch (every rank passes the same), each
    leaf placed by ``batch_spec`` (one spec for every leaf, or a tree);
    the loss returned is the global one, on every rank.

    ``loss_fn(params, batch)`` sees global shapes.  A parameter split over
    an axis that also splits the batch (FSDP) is gathered over that axis
    first.  After the backward each gradient is redistributed to its
    parameter's placement (or, under ``zero1``, its optimizer shard's):
    an all-reduce of the pending sum over the batch axes, a reduce-scatter
    for a split one.  A parameter without a gradient gets zeros, as in the
    JAX step.

    ``zero1=True`` needs the optimizer of ``zero1_init``; the specs of its
    shards come from ``zero1_specs`` or are derived from ``params``'
    shapes (one of the two is required, as in the JAX package).
    """
    from torch.distributed.tensor import Replicate
    placements = tree_leaves(make_param_shardings(mesh, param_specs))
    names = _axis_names(dtensor_mesh(mesh))
    batch_dims = {names.index(a) for a in _batch_axes(batch_spec)
                  if a in names}
    z_placements = None
    if zero1:
        if zero1_specs is None:
            if params is None:
                raise TypeError(
                    "zero1=True derives opt-state shardings from the "
                    "param shapes — pass params=<your param tree> "
                    "(shapes/structure only are read), or a precomputed "
                    "zero1_specs=zero1_opt_specs(...)")
            zero1_specs = zero1_opt_specs(optimizer, params, mesh,
                                          param_specs, dp_axis=zero1_axis)
        z_placements = tree_leaves(make_param_shardings(mesh, zero1_specs))

    def for_loss(p):
        # FSDP: gather the batch axes' splits for the loss; the backward of
        # this redistribute reduce-scatters the gradient onto the shard.
        pl = tuple(Replicate() if i in batch_dims and s.is_shard() else s
                   for i, s in enumerate(p.placements))
        return p if pl == tuple(p.placements) else p.redistribute(
            placements=pl)

    def opt_params(leaves):
        if not zero1:
            return leaves
        got = [q for g in optimizer.param_groups for q in g["params"]]
        if len(got) != len(leaves) or any(
                tuple(s.shape) != tuple(p.shape)
                or tuple(getattr(s, "placements", ())) != pl
                for s, p, pl in zip(got, leaves, z_placements)):
            raise ValueError(
                "zero1=True steps the optimizer of zero1_init(make_optimizer,"
                " params, mesh, param_specs): its parameters must be the dp "
                "shards of params' leaves, in tree order")
        return got

    def step(params: Tree, batch) -> torch.Tensor:
        leaves = tree_leaves(params)
        for p, pl in zip(leaves, placements):
            _check_placed(p, "build_sharded_train_step", pl)
            p.grad = None
        targets = opt_params(leaves)
        for s in targets:
            s.grad = None
        view = tree_unflatten(params, [for_loss(p) for p in leaves])
        loss = loss_fn(view, _place_batch(batch, mesh, batch_spec))
        loss.backward()
        for p, s in zip(leaves, targets):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if s is not p:
                p.grad = None
            s.grad = g.redistribute(placements=s.placements)
        optimizer.step()
        with torch.no_grad():
            for p, s in zip(leaves, targets):
                if s is not p:
                    p.copy_(s.redistribute(placements=p.placements))
        loss = loss.detach()
        return loss.full_tensor() if is_dtensor(loss) else loss

    return step
