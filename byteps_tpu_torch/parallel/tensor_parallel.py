"""Tensor parallelism: Megatron-style column/row sharded matmuls.

Counterpart of ``byteps_tpu/parallel/tensor_parallel.py``.  Two ways to
use it, as there:

  1. DTensor (``parallel/sharded.py``): place the weights by the
     PartitionSpecs of ``models.transformer.param_specs`` and let DTensor's
     sharding propagation place the collectives — column-parallel layers
     need no forward communication, row-parallel layers one sum.
  2. Explicit: the helpers below spell the same math out for code that
     runs per rank on its local blocks (``models/hybrid.py``), where each
     rank's autograd is local.  Each takes the tp process ``group`` (None:
     the default group), as ``ops/collectives.py`` does; a group of one
     rank makes every collective the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import collectives


def col_parallel_dense(x: torch.Tensor, w_local: torch.Tensor,
                       b_local: torch.Tensor = None) -> torch.Tensor:
    """Column-parallel dense: inputs replicated, weight column-sharded.
    y_local = x @ W_local — no communication in forward; the caller's
    ``copy_to`` (the Megatron "f" operator) sums dx in backward."""
    y = x @ w_local
    if b_local is not None:
        y = y + b_local
    return y


def row_parallel_dense(x_local: torch.Tensor, w_local: torch.Tensor,
                       b: torch.Tensor = None, group=None) -> torch.Tensor:
    """Row-parallel dense: inputs sharded on the contracting dim, weight
    row-sharded; partial products are summed (the Megatron "g" operator,
    with the transpose-safe adjoint).  Bias is added once, after the
    sum."""
    y = reduce_from(group)(x_local @ w_local)
    if b is not None:
        y = y + b
    return y


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(group=None):
    """The Megatron "f" operator: forward identity, backward all-reduce.

    Each rank's autograd is local, so a replicated activation entering
    column-parallel branches needs its cotangents summed across the tp
    ranks explicitly; this returns that identity with an all-reduce
    adjoint."""
    def f(x):
        if collectives.axis_size(group) == 1:
            return x
        return _CopyTo.apply(x, group)
    return f


def reduce_from(group=None):
    """The Megatron "g" operator: forward all-reduce, backward identity.

    A raw all-reduce differentiated as its own transpose (another
    all-reduce) would over-count the cotangent by the group's size when
    the loss downstream is computed replicated on every rank; this pins
    the adjoint to the identity: the replicated cotangent passes through
    once."""
    def g(x):
        if collectives.axis_size(group) == 1:
            return x
        return _ReduceFrom.apply(x, group)
    return g


def tp_split(x: torch.Tensor, axis: int, group=None) -> torch.Tensor:
    """This rank's chunk of a replicated tensor along ``axis`` (activation
    entering a row-parallel layer); its adjoint places the cotangent in
    the chunk, zeros elsewhere."""
    n = collectives.axis_size(group)
    if n == 1:
        return x
    size = x.shape[axis] // n
    return x.narrow(axis, dist.get_rank(group) * size, size)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return collectives.all_gather(x, group, axis=axis, tiled=True)

    @staticmethod
    def backward(ctx, g):
        return (collectives.reduce_scatter(g.contiguous(), ctx.group,
                                           axis=ctx.axis), None, None)


def tp_all_gather(x_local: torch.Tensor, axis: int,
                  group=None) -> torch.Tensor:
    """Re-assemble a sharded activation along ``axis`` (exit of a
    column-parallel layer when the next op needs the full feature dim).
    The adjoint is JAX's for a tiled all-gather: a reduce-scatter."""
    if collectives.axis_size(group) == 1:
        return x_local
    return _AllGather.apply(x_local, axis, group)
