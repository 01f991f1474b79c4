"""Pipeline parallelism: SPMD GPipe over the pp process group.

Counterpart of ``byteps_tpu/parallel/pipeline.py``.  The schedule is GPipe
with M microbatches over P stages: every rank runs the same eager loop of
M + P - 1 ticks; at each tick a stage applies its layer slice to the
microbatch it holds, then passes the activation to the next stage with
``collectives.ppermute`` (whose adjoint is the reverse permutation).  The
backward pass through the loop is the reverse pipeline.

Every rank builds the same autograd graph, whatever its stage (masks
instead of branches, as the JAX scan's ``jnp.where``s), so the
collectives of the backward pass meet in the same order on every rank.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..common.tree import tree_map
from ..ops import collectives

Tree = Any


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank: JAX's
    ``all_gather(x, axis, tiled=False)[P - 1]`` and its exact adjoint, the
    cotangents of every rank summed onto the last stage (zeros on the
    others), so a loss that is not masked to one rank still counts each
    rank's share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        last = collectives._global_rank(group, dist.get_world_size(group) - 1)
        out = x.detach().contiguous().clone()
        dist.broadcast(out, src=last, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        total = collectives.all_reduce(g.contiguous().clone(), ctx.group)
        world = dist.get_world_size(ctx.group)
        if dist.get_rank(ctx.group) != world - 1:
            total = torch.zeros_like(total)
        return total, None


def gpipe_spmd(
    stage_fn: Callable[[Tree, torch.Tensor], Any],
    stage_params: Tree,
    x: torch.Tensor,
    num_microbatches: int,
    group=None,
    with_aux: bool = False,
):
    """Run ``x`` through P pipeline stages, the ranks of ``group``.

    ``stage_fn(stage_params, mb) -> mb`` applies THIS rank's layer slice
    (or ``-> (mb, aux_scalar)`` when ``with_aux``); ``stage_params`` are
    the local stage weights.  x: [B, ...] cut along dim 0 into
    ``num_microbatches`` chunks (B % num_microbatches == 0); a stage's
    output has its input's shape.  Returns [B, ...] final-stage outputs,
    replicated to every rank; with ``with_aux`` also THIS stage's aux
    scalar summed over its real microbatch ticks (bubble ticks carry
    garbage activations and are masked out).  The aux stays per rank:
    summing across ranks is the caller's loss reduction.
    """
    P = collectives.axis_size(group)
    idx = dist.get_rank(group) if P > 1 else 0
    M = num_microbatches
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    mbs = x.reshape(M, B // M, *x.shape[1:])

    def run_stage(inp):
        res = stage_fn(stage_params, inp)
        return res if with_aux else (res, torch.zeros((), device=x.device))

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=x.device)

    first = flag(idx == 0)
    prev_out = None
    outs = [None] * M
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(M + P - 1):
        # What arrives from the previous stage this tick (nothing yet at 0).
        recvd = (torch.zeros_like(mbs[0]) if prev_out is None
                 else collectives.ppermute(prev_out, 1, group))
        # Stage 0 feeds fresh microbatches while they last.
        feed = mbs[min(t, M - 1)].to(recvd.dtype)
        out, aux = run_stage(torch.where(first, feed, recvd))
        # Stage idx works on real microbatch t - idx at this tick; other
        # ticks are bubbles whose aux is garbage.
        valid = flag(t >= idx and t - idx < M)
        aux_acc = aux_acc + torch.where(valid, aux, torch.zeros_like(aux))
        # The last stage finishes microbatch t - (P - 1) at this tick.
        m = t - (P - 1)
        if m >= 0:
            outs[m] = torch.where(flag(idx == P - 1), out,
                                  torch.zeros_like(out))
        prev_out = out
    result = torch.stack(outs)
    if P > 1:
        result = _FromLast.apply(result, group)
    result = result.reshape((B,) + tuple(result.shape[2:]))
    return (result, aux_acc) if with_aux else result


def shard_stage_params(params: Tree, num_stages: int) -> Tree:
    """Reshape stacked-layer params [L, ...] -> [P, L/P, ...] so the leading
    axis can be sharded over pp (each stage holds L/P layers)."""
    def f(p):
        L = p.shape[0]
        if L % num_stages != 0:
            raise ValueError(f"{L} layers not divisible into "
                             f"{num_stages} stages")
        return p.reshape(num_stages, L // num_stages, *p.shape[1:])
    return tree_map(f, params)
