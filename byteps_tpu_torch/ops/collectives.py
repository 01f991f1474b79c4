"""Collective data plane on ``torch.distributed``.

Counterpart of ``byteps_tpu/ops/collectives.py``.  What carries over from
the reference design is the scheduling structure:

  - gradients are cut into buckets of at most BYTEPS_PARTITION_BYTES,
    composed by the shared planner (``common/fusion.py:plan_segments``);
  - buckets are reduced in priority order — the leaves produced first by
    the backward pass (the tail of the tree) go first.

The JAX functions take a mesh ``axis_name``; these take a process
``group`` (None: the default group).  Under ``local_mode()`` every
collective is the identity and the world size is 1, as the JAX package's
single-device fast path makes it.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common.config import get_config
from ..common.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any

_local_mode: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "byteps_tpu_torch_local_mode", default=False)


@contextlib.contextmanager
def local_mode():
    tok = _local_mode.set(True)
    try:
        yield
    finally:
        _local_mode.reset(tok)


def is_local() -> bool:
    return _local_mode.get()


def axis_size(group=None) -> int:
    """Ranks in the group: 1 in local mode or without a process group."""
    if is_local() or not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Thin wrappers.
# ---------------------------------------------------------------------------
def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group.  Reduces ``x`` in place and returns it."""
    if is_local():
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group=None, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    if is_local():
        return x if tiled else x.unsqueeze(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def reduce_scatter(x: torch.Tensor, group=None,
                   axis: int = 0) -> torch.Tensor:
    """Sum over the group, keep this rank's 1/world slice along ``axis``."""
    if is_local():
        return x
    world = dist.get_world_size(group)
    if x.shape[axis] % world:
        raise ValueError(f"dim {axis} of size {x.shape[axis]} does not "
                         f"split over {world} ranks")
    if dist.get_backend(group) == dist.Backend.GLOO:
        # gloo has no reduce-scatter: reduce everything, keep the slice.
        full = all_reduce(x.clone(), group)
        return full.chunk(world, axis)[dist.get_rank(group)].contiguous()
    if axis == 0:
        # NCCL's reduce_scatter_tensor: equal splits of one contiguous
        # buffer, no per-rank copies.
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
        return out
    parts = [p.contiguous() for p in x.chunk(world, axis)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    return out


# ---------------------------------------------------------------------------
# Differentiable collectives of the sequence-parallel plane.  Their backward
# is the transpose JAX takes: the reverse permutation, the swapped
# all-to-all.  At one rank both are the identity.
# ---------------------------------------------------------------------------
def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _shift(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      _global_rank(group, (me + shift) % world), group),
           dist.P2POp(dist.irecv, out,
                      _global_rank(group, (me - shift) % world), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _shift(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.shift, ctx.group), None, None


def ppermute(x: torch.Tensor, shift: int = 1, group=None) -> torch.Tensor:
    """Ring permutation (``lax.ppermute`` with perm i -> i + shift): each
    rank sends ``x`` to rank + shift and returns what rank - shift sent."""
    if axis_size(group) == 1:
        return x
    return _PPermute.apply(x, shift, group)


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
                group) -> torch.Tensor:
    world = dist.get_world_size(group)
    if x.shape[split_axis] % world:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {world} ranks")
    ins = [p.contiguous() for p in x.chunk(world, split_axis)]
    outs = [torch.empty_like(ins[0]) for _ in range(world)]
    dist.all_to_all(outs, ins, group=group)
    return torch.cat(outs, concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, concat_axis, split_axis, ctx.group), None, \
            None, None


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group=None) -> torch.Tensor:
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``): ``x`` is cut
    into world chunks along ``split_axis``, chunk i goes to rank i, and the
    chunks received are concatenated along ``concat_axis`` in rank order."""
    if axis_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_axis, concat_axis, group)


# ---------------------------------------------------------------------------
# Bucketing: the partitioner applied to a flattened gradient tree.
# ---------------------------------------------------------------------------
class BucketPlan:
    """Static plan mapping tree leaves <-> priority-ordered buckets."""

    def __init__(self, sizes: Sequence[int], partition_bytes: int,
                 itemsize: int, reverse: bool = True):
        from ..common.fusion import plan_segments
        part_elems = max(1, partition_bytes // max(1, itemsize))
        # Each bucket is a list of (leaf_idx, start, length) segments.
        self.buckets: List[List[Tuple[int, int, int]]] = plan_segments(
            sizes, part_elems, reverse)
        self.sizes = list(sizes)

    def num_buckets(self) -> int:
        return len(self.buckets)


@functools.lru_cache(maxsize=256)
def _plan_cache(sizes: Tuple[int, ...], partition_bytes: int, itemsize: int,
                reverse: bool) -> BucketPlan:
    return BucketPlan(sizes, partition_bytes, itemsize, reverse)


def _comm_dtype(dtypes) -> torch.dtype:
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def bucketed_tree_all_reduce(
    tree: Tree,
    group=None,
    average: bool = True,
    partition_bytes: Optional[int] = None,
    bucket_transform: Optional[Callable[[torch.Tensor, int],
                                        torch.Tensor]] = None,
) -> Tree:
    """Partitioned, priority-ordered all-reduce of a gradient tree.

    Each <= partition_bytes bucket is reduced by its own all-reduce, in
    backward-completion order.  ``bucket_transform``, when given, maps
    (bucket, bucket_index) -> reduced bucket and replaces the all-reduce;
    it is the hook the compression plane uses.  Each bucket runs inside a
    ``byteps.bucket<N>`` profiler range.
    """
    if is_local() and bucket_transform is None:
        # One worker: the sum is the identity and the average divides by 1.
        return tree
    pb = partition_bytes or get_config().partition_bytes
    all_leaves = tree_leaves(tree)
    nonempty_idx = [i for i, l in enumerate(all_leaves) if l.numel() > 0]
    leaves = [all_leaves[i] for i in nonempty_idx]
    if not leaves:
        return tree
    orig_dtypes = [l.dtype for l in leaves]
    comm_dtype = _comm_dtype(orig_dtypes)
    flat = [l.to(comm_dtype).reshape(-1) for l in leaves]
    sizes = tuple(l.numel() for l in leaves)
    itemsize = torch.empty((), dtype=comm_dtype).element_size()
    plan = _plan_cache(sizes, pb, itemsize, True)
    denom = axis_size(group) if average else None

    out_segments: List[List[torch.Tensor]] = [[] for _ in leaves]
    seg_starts: List[List[int]] = [[] for _ in leaves]
    for bi, bucket in enumerate(plan.buckets):
        with torch.profiler.record_function(f"byteps.bucket{bi}"):
            parts = [flat[li][start:start + length]
                     for (li, start, length) in bucket]
            buf = torch.cat(parts)        # a fresh buffer, safe to reduce
            if bucket_transform is not None:
                buf = bucket_transform(buf, bi)
            else:
                buf = all_reduce(buf, group)
            if average:
                buf = buf / denom
        off = 0
        for (li, start, length) in bucket:
            out_segments[li].append(buf[off:off + length])
            seg_starts[li].append(start)
            off += length
    reduced = []
    for li, leaf in enumerate(leaves):
        segs = out_segments[li]
        # Segments of one leaf arrive tail-first; restore offset order.
        order = sorted(range(len(segs)), key=lambda i: seg_starts[li][i])
        vec = torch.cat([segs[i] for i in order]) if len(segs) > 1 \
            else segs[0]
        reduced.append(vec.reshape(leaf.shape).to(orig_dtypes[li]))
    out_leaves = list(all_leaves)
    for i, r in zip(nonempty_idx, reduced):
        out_leaves[i] = r
    return tree_unflatten(tree, out_leaves)


def tree_all_reduce(tree: Tree, group=None, average: bool = True) -> Tree:
    """Unbucketed baseline: one all-reduce per leaf."""
    def f(x):
        y = all_reduce(x.clone(), group)
        return y / axis_size(group) if average else y
    return tree_map(f, tree)


# ---------------------------------------------------------------------------
# Hierarchical reduction over ('dcn_dp', 'ici_dp') — the two-level analog of
# the reference's NCCL-reduce-scatter -> ps-push/pull -> NCCL-all-gather.
# The groups are the axes of a two-level DeviceMesh
# (parallel/mesh.py::make_hierarchical_mesh), get_mesh() by default.
# ---------------------------------------------------------------------------
def _two_level_groups(mesh, ici_axis: str, dcn_axis: str):
    if mesh is None:
        from ..parallel.mesh import get_mesh
        mesh = get_mesh()
    names = tuple(mesh.mesh_dim_names or ())
    if ici_axis not in names or dcn_axis not in names:
        raise ValueError(
            f"the hierarchical reduce needs a mesh with axes "
            f"({dcn_axis!r}, {ici_axis!r}), got {names}: pass "
            f"make_hierarchical_mesh() or set_mesh() it")
    return mesh.get_group(ici_axis), mesh.get_group(dcn_axis)


def hierarchical_all_reduce(x: torch.Tensor, mesh=None,
                            ici_axis: str = "ici_dp",
                            dcn_axis: str = "dcn_dp",
                            average: bool = False) -> torch.Tensor:
    """Reduce-scatter on the ICI (intra-node) group, all-reduce the shard
    over the DCN group, all-gather on the ICI group.

    Requires x's leading dim divisible by the ICI group's size (callers pad
    flat buckets).  Cross-node traffic is 1/ici_size of the flat
    all-reduce's.  Under ``local_mode()`` the result is ``x``.
    """
    if is_local():
        return x
    ici, dcn = _two_level_groups(mesh, ici_axis, dcn_axis)
    shard = reduce_scatter(x, ici, axis=0)
    shard = all_reduce(shard, dcn)
    out = all_gather(shard, ici, axis=0, tiled=True)
    if average:
        out = out / (dist.get_world_size(ici) * dist.get_world_size(dcn))
    return out


def hierarchical_tree_all_reduce(tree: Tree, mesh=None,
                                 ici_axis: str = "ici_dp",
                                 dcn_axis: str = "dcn_dp",
                                 average: bool = True,
                                 partition_bytes: Optional[int] = None
                                 ) -> Tree:
    """Bucketed hierarchical all-reduce of a gradient tree: the buckets of
    ``bucketed_tree_all_reduce``, each zero-padded to a multiple of the ICI
    size (NCCL's reduce-scatter takes equal splits) and reduced by
    ``hierarchical_all_reduce``; the average divides once at the end.
    Under ``local_mode()`` the result is the tree."""
    if is_local():
        return tree
    ici_group, dcn_group = _two_level_groups(mesh, ici_axis, dcn_axis)
    ici = dist.get_world_size(ici_group)

    def transform(buf: torch.Tensor, bi: int) -> torch.Tensor:
        del bi
        pad = (-buf.numel()) % ici
        if pad:
            buf = torch.cat([buf, buf.new_zeros(pad)])
        out = hierarchical_all_reduce(buf, mesh, ici_axis, dcn_axis)
        return out[:out.numel() - pad] if pad else out

    out = bucketed_tree_all_reduce(tree, group=ici_group, average=False,
                                   partition_bytes=partition_bytes,
                                   bucket_transform=transform)
    if average:
        n = ici * dist.get_world_size(dcn_group)
        out = tree_map(lambda l: l / n, out)
    return out
