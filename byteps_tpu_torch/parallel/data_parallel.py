"""Data-parallel training: DistributedOptimizer and the train step.

Counterpart of ``byteps_tpu/parallel/data_parallel.py``.  The JAX package
wraps an optax transform and traces the whole step under jit; here
``DistributedOptimizer`` wraps a ``torch.optim.Optimizer`` and, before each
update, reduces the gradients with the partitioned, priority-ordered
all-reduce of ``ops.collectives`` — bucket 0 holds the tail of the
parameter list, the first gradients out of the backward pass.  Build the
inner optimizer over ``common.tree.tree_leaves(params)`` so the leaf order,
and with it the bucket plan, is the JAX package's.

With ``inter_compressor`` (an ``ops.compressor`` instance, e.g.
``ops.compressor.create({"compressor": "onebit", "ef": "vanilla",
"momentum": "nesterov"})``) the buckets go through
``compressed_tree_all_reduce`` instead, and the optimizer holds this rank's
compressor state as ``compression_state``.  With ``hierarchical=True`` they
go through ``hierarchical_tree_all_reduce`` over a two-level mesh
(``parallel/mesh.py::make_hierarchical_mesh``): reduce-scatter within a
node, all-reduce of the shard across nodes, all-gather within the node.

PyTorch updates parameters in place, which is what the JAX step's buffer
donation buys there: ``build_train_step``'s step returns only the loss.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..common import devprof
from ..common.device import DeviceLike, resolve_device
from ..common.tree import tree_leaves
from ..ops import collectives
from ..ops.compression import Compression, Compressor
from ..ops.compressor import (InterCompressor, compressed_tree_all_reduce,
                              init_compression_state)

Tree = Any


class DistributedOptimizer:
    """Wrap a torch optimizer so each ``step()`` first all-reduces (and by
    default averages) the gradients of its parameters over the group.

    ``compression`` is the cast applied around the reduce
    (``Compression.fp16`` sends bf16).  ``backward_passes_per_step > 1``
    scales the reduced gradients by its inverse, for loops that accumulate
    that many backward passes per step.  ``named_parameters`` is accepted
    for API parity and unused.

    ``inter_compressor`` compresses every bucket on its way through the
    reduce.  Its state (error feedback, momentum, PRNG lanes) is built from
    the post-``compression`` wire tree of the parameters, lives on their
    device as ``compression_state``, and is this rank's own, as each
    worker's is in the reference.  ``world``, when given, must equal the
    group's size (the JAX package's per-worker state tiling needs it; here
    it is only checked).

    ``hierarchical=True`` reduces over the two-level mesh ``mesh`` (default:
    ``make_hierarchical_mesh()`` over the world, BYTEPS_TPU_ICI_SIZE ranks
    an island, on the parameters' device type, built here: every rank
    constructs the optimizer).  It uses the mesh's groups at any size, a
    world of one included; ``inter_compressor``, when also given, takes
    precedence, as in the reference.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Any = None,
                 compression: Optional[Compressor] = None,
                 inter_compressor: Optional[Any] = None,
                 group=None,
                 average: bool = True,
                 partition_bytes: Optional[int] = None,
                 hierarchical: bool = False,
                 backward_passes_per_step: int = 1,
                 world: Optional[int] = None,
                 mesh=None):
        del named_parameters
        if inter_compressor is not None and not isinstance(
                inter_compressor, InterCompressor):
            raise TypeError(
                f"inter_compressor must be an ops.compressor InterCompressor "
                f"(e.g. ops.compressor.create(...)), got "
                f"{type(inter_compressor).__name__}")
        if world is not None and world != collectives.axis_size(group):
            raise ValueError(
                f"world={world} but the process group has "
                f"{collectives.axis_size(group)} ranks")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.compression = compression or Compression.none
        self.group = group
        self.average = average
        self.partition_bytes = partition_bytes
        self.backward_passes_per_step = backward_passes_per_step
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.hierarchical = hierarchical and inter_compressor is None
        self.mesh = None
        if self.hierarchical:
            from .mesh import make_hierarchical_mesh
            self.mesh = mesh if mesh is not None else make_hierarchical_mesh(
                device_type=self.params[0].device.type)
        self.inter_compressor = inter_compressor
        self.compression_state = None
        if inter_compressor is not None:
            # The bucket plan must be synchronize()'s, which bucketizes the
            # post-cast wire tree.
            wire = [self.compression.compress(p.detach())[0]
                    for p in self.params]
            self.compression_state = init_compression_state(
                wire, inter_compressor, partition_bytes)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def synchronize(self) -> None:
        """Replace every parameter's gradient by its reduced value.  A
        parameter without a gradient contributes zeros, so every rank
        reduces the same buckets."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        packed = [self.compression.compress(g) for g in grads]
        wire = [w for w, _ in packed]
        if collectives.axis_size(self.group) == 1 and not self.hierarchical:
            with collectives.local_mode():
                reduced = self._reduce(wire)
        else:
            reduced = self._reduce(wire)
        scale = 1.0 / self.backward_passes_per_step
        for p, r, (_, ctx) in zip(self.params, reduced, packed):
            g = self.compression.decompress(r, ctx)
            p.grad = g * scale if scale != 1.0 else g

    def _reduce(self, wire):
        if self.inter_compressor is not None:
            reduced, self.compression_state = compressed_tree_all_reduce(
                wire, self.inter_compressor, self.compression_state,
                group=self.group, average=self.average,
                partition_bytes=self.partition_bytes)
            return reduced
        if self.hierarchical:
            return collectives.hierarchical_tree_all_reduce(
                wire, self.mesh, average=self.average,
                partition_bytes=self.partition_bytes)
        return collectives.bucketed_tree_all_reduce(
            wire, group=self.group, average=self.average,
            partition_bytes=self.partition_bytes)

    def step(self, closure: Optional[Callable] = None):
        self.synchronize()
        return self.optimizer.step(closure)


def build_train_step(loss_fn: Callable[..., torch.Tensor],
                     optimizer: Any,
                     accum_steps: int = 1,
                     device: DeviceLike = None) -> Callable:
    """Returns ``step(params, batch) -> loss``: forward, backward, gradient
    reduce (through a DistributedOptimizer) and update, in place.

    ``params`` is the parameter tree the optimizer was built over; the
    batch is this rank's shard, and the loss returned is the mean over
    ranks.  ``accum_steps > 1`` splits the batch (dim 0) into that many
    microbatches and averages their gradients in float32 before the one
    reduce of the step; it refuses a DistributedOptimizer with
    ``backward_passes_per_step > 1``, the other form of the same average.
    A world of one runs under ``collectives.local_mode()``: no collective,
    unless the optimizer is hierarchical: then the step reduces over its
    mesh's groups at any size, and the loss returned is the mean over both
    of its levels.  ``device`` (default CUDA) is where the params must
    live.
    """
    dev = resolve_device(device)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if (accum_steps > 1
            and getattr(optimizer, "backward_passes_per_step", 1) > 1):
        raise ValueError(
            "accum_steps and DistributedOptimizer(backward_passes_per_step)"
            " are alternative forms of the same averaging — combining them"
            " would divide the update by the product.  Use accum_steps for"
            " in-step accumulation, or backward_passes_per_step when the"
            " training loop itself calls step() once per pass.")

    def _value_and_grad(leaves, params, batch) -> torch.Tensor:
        for p in leaves:
            p.grad = None
        if accum_steps == 1:
            loss = loss_fn(params, batch)
            loss.backward()
            return loss.detach()

        def split(x):
            if x.shape[0] % accum_steps:
                raise ValueError(
                    f"per-rank batch dim {x.shape[0]} is not divisible by "
                    f"accum_steps={accum_steps}")
            return x.chunk(accum_steps, 0)

        micros = list(zip(*(split(x) for x in batch)))
        # Accumulate in f32 whatever the grad dtype, so the average equals
        # the full-batch gradient; cast back after averaging.
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for mb in micros:
            for p in leaves:
                p.grad = None
            loss = loss_fn(params, mb)
            loss.backward()
            loss_sum += loss.detach().float()
            for s, p in zip(g_sum, leaves):
                if p.grad is not None:
                    s += p.grad.float()
        inv = 1.0 / accum_steps
        for s, p in zip(g_sum, leaves):
            p.grad = (s * inv).to(p.dtype)
        return loss_sum * inv

    def step(params: Tree, batch) -> torch.Tensor:
        leaves = tree_leaves(params)
        if leaves[0].device.type != dev.type:
            raise ValueError(f"params live on {leaves[0].device}, the step "
                             f"was built for {dev}")
        mesh = getattr(optimizer, "mesh", None)
        if getattr(optimizer, "hierarchical", False) and \
                not collectives.is_local():
            loss = _value_and_grad(leaves, params, batch)
            optimizer.step()
            total = loss.clone()
            for axis in mesh.mesh_dim_names:
                collectives.all_reduce(total, mesh.get_group(axis))
            return total / mesh.size()
        group = getattr(optimizer, "group", None)
        world = collectives.axis_size(group)
        if world == 1:
            with collectives.local_mode():
                loss = _value_and_grad(leaves, params, batch)
                optimizer.step()
            return loss
        loss = _value_and_grad(leaves, params, batch)
        optimizer.step()
        # Per-rank losses -> global mean for reporting.
        return collectives.all_reduce(loss.clone(), group) / world

    cpu_requested = device is not None and dev.type == "cpu"

    def call(params: Tree, batch) -> torch.Tensor:
        # Device-plane hook (common/devprof.py): unarmed this is one None
        # check; armed it counts the first call's FLOPs and syncs in
        # step_end to record the step's dispatch-to-ready time.
        tok = devprof.step_begin(step, (params, batch), cpu_requested)
        if tok is None:
            return step(params, batch)
        try:
            loss = step(params, batch)
        except BaseException:
            devprof.step_abort(tok)
            raise
        devprof.step_end(tok, loss)
        return loss

    return call
