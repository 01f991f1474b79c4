"""Expert parallelism: Switch-style MoE with all-to-all dispatch over ep.

Counterpart of ``byteps_tpu/parallel/expert.py``.  Top-1 (Switch) routing
with capacity limiting; experts are split over the ranks of the ep process
group, and tokens travel to their expert's rank through one tiled
all-to-all each way (``collectives.all_to_all``); dispatch and combine are
one-hot einsums.  A group of one rank makes the all-to-alls the identity.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..common.device import DeviceLike, resolve_device
from ..ops import collectives
from .sharded import PartitionSpec as P
from .tensor_parallel import copy_to

Tree = Any


def init_moe_params(generator: torch.Generator, num_experts: int,
                    d_model: int, d_ff: int, dtype=torch.float32,
                    device: DeviceLike = None) -> Tree:
    """Gate and expert weights, normal/sqrt(fan_in), from ``generator``
    (the JAX package's init, other numbers)."""
    dev = resolve_device(device)

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device) / math.sqrt(fan_in)
        return t.to(dev).requires_grad_()
    return {
        "gate_w": w((d_model, num_experts), d_model),
        "ffn_in": w((num_experts, d_model, d_ff), d_model),
        "ffn_out": w((num_experts, d_ff, d_model), d_ff),
    }


def moe_params_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """The JAX package's MoE params as numpy arrays, as leaf tensors."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(tree[k], np.float32),
                            device=dev).requires_grad_()
            for k in ("gate_w", "ffn_in", "ffn_out")}


def moe_param_specs(ep_axis: str = "ep") -> Tree:
    return {"gate_w": P(None, None),
            "ffn_in": P(ep_axis, None, None),
            "ffn_out": P(ep_axis, None, None)}


def _dispatch_masks(gate_logits: torch.Tensor, num_experts: int,
                    capacity: int):
    """Top-1 routing -> (dispatch [T,E,C], combine [T,E,C] f32, aux_loss).
    T = local token count.  argmax takes the first of tied experts; a
    token's place in its expert's queue is a float32 cumsum; tokens past
    the capacity are dropped (zero rows)."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)                                 # [T]
    gate = probs.gather(-1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, num_experts).float()               # [T,E]
    # Position of each token within its expert's queue.
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot            # [T,E]
    onehot = onehot * (pos < capacity)
    # jax.nn.one_hot: an index past the capacity gives a zero row.
    slots = torch.arange(capacity, device=pos.device)
    cap_onehot = (pos.to(torch.int32)[..., None] == slots).float()
    dispatch = onehot[..., None] * cap_onehot                     # [T,E,C]
    combine = dispatch * gate[:, None, None]
    # Switch load-balancing auxiliary loss.
    density = onehot.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * num_experts
    return dispatch, combine, aux


def moe_core(gate_w: torch.Tensor, ffn_in: torch.Tensor,
             ffn_out: torch.Tensor, x: torch.Tensor,
             capacity_factor: float = 2.0,
             group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Switch-MoE data path on this rank's tokens.

    x: [T_local, D]; ffn_in/ffn_out: this rank's expert slice
    [E_local, D, F] / [E_local, F, D]; gate_w [D, E_global] replicated.
    Returns (y [T_local, D], aux load-balancing loss — local, not reduced).
    Shared by ``moe_layer`` and the hybrid model's FFN.
    """
    world = collectives.axis_size(group)
    e_local = ffn_in.shape[0]
    E = e_local * world
    T = x.shape[0]
    capacity = max(1, int(capacity_factor * T / E))

    logits = x @ gate_w                                            # [T, E]
    dispatch, combine, aux = _dispatch_masks(logits, E, capacity)

    # Tokens -> expert buffers [E, C, D]; split experts across ranks, gather
    # the share of every peer's tokens for my local experts.
    buffers = torch.einsum("tec,td->ecd", dispatch, x.float())
    # [E, C, D] -> [E/world, world*C, D]
    recv = collectives.all_to_all(buffers, 0, 1, group)
    h = torch.einsum("ecd,edf->ecf", recv, ffn_in.float())
    h = F.gelu(h, approximate="tanh")               # jax.nn.gelu's default
    h = torch.einsum("ecf,efd->ecd", h, ffn_out.float())
    # Route results back to the owners of the tokens.
    back = collectives.all_to_all(h, 1, 0, group)                  # [E, C, D]
    y = torch.einsum("tec,ecd->td", combine, back)
    return y.to(x.dtype), aux


class _MeanFrom(torch.autograd.Function):
    """Mean over the group; adjoint 1/n of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return collectives.all_reduce(x.detach().clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_layer_shard(params: Tree, x: torch.Tensor,
                    capacity_factor: float = 2.0,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank Switch-MoE layer.

    x: [T_local, D] tokens on this rank; params['ffn_*'] hold the LOCAL
    expert slice [E_local, ...]; gate_w is replicated.  Returns (y,
    aux_loss averaged over the group)."""
    y, aux = moe_core(params["gate_w"], params["ffn_in"], params["ffn_out"],
                      x, capacity_factor, group)
    if collectives.axis_size(group) > 1:
        aux = _MeanFrom.apply(aux, group)
    return y, aux


def moe_layer(params: Tree, x: torch.Tensor, mesh,
              capacity_factor: float = 2.0,
              axis_name: str = "ep") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-shape MoE layer: tokens and experts split over ``axis_name``
    of ``mesh``.

    x: [T, D], params whole, the same on every rank (T and E divisible by
    the axis size).  Each rank routes its block of T and runs its block of
    experts; y [T, D] and the aux loss come back whole on every rank.
    Differentiable as one replicated function: a loss that every rank
    computes the same gives every rank the gradients of x and of all the
    params (sums over the ranks' tokens)."""
    group = mesh.get_group(axis_name)
    n = collectives.axis_size(group)
    if n == 1:
        return moe_layer_shard(params, x, capacity_factor, group)
    me = dist.get_rank(group)
    f = copy_to(group)                    # replicated input, summed adjoint

    def block(t, axis=0):
        size = t.shape[axis] // n
        return f(t).narrow(axis, me * size, size)
    local = {"gate_w": f(params["gate_w"]),
             "ffn_in": block(params["ffn_in"]),
             "ffn_out": block(params["ffn_out"])}
    y, aux = moe_layer_shard(local, block(x), capacity_factor, group)
    return _GatherRows.apply(y, group), aux


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the adjoint of a replicated cotangent is this
    rank's rows of it."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return collectives.all_gather(y.contiguous(), group, axis=0)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, 0)[dist.get_rank(ctx.group)], None
