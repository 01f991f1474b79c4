"""The Horovod-style torch face: the reference's ``byteps.torch`` surface on
the port, so that a training script moves from ``byteps_tpu.torch`` by
changing its import.

Counterpart of ``byteps_tpu/torch/__init__.py``, which carries every tensor
through JAX on the host.  Here tensors stay on their device and ride the
eager API of ``common.api`` (``torch.distributed`` collectives):

  - ``push_pull(_async, _async_inplace)``, ``synchronize``, ``poll``: the
    result is written back into the tensor handed in;
  - ``DistributedOptimizer(optimizer, named_parameters, compression,
    backward_passes_per_step)``: each gradient's ``push_pull_async``
    (named ``"Gradient." + name``, priority the reverse of its declaration
    index: the first parameters, needed first by the next forward, go
    first) starts from a post-accumulate-grad hook as soon as its last
    backward pass of the step has accumulated it, overlapping the rest of
    the backward; ``step()`` synchronizes every handle, then steps the
    inner optimizer;
  - ``broadcast_parameters``, ``broadcast_optimizer_state`` (scalar state
    tensorized), ``DistributedDataParallel`` (gradient sync from an
    end-of-backward engine callback, buffers re-broadcast each forward);
  - ``HalfPrecisionDistributedOptimizer`` and ``broadcast_fp16_parameters``
    (``fp16.py``);
  - ``CrossBarrier`` (``cross_barrier.py``): per-parameter updates applied
    by a poller thread as each gradient's push_pull completes, the next
    forward waiting per layer.

``BYTEPS_DEBUG_SAMPLE_TENSOR`` samples here as in the eager API, whose
``push_pull_async`` and ``synchronize`` every push_pull passes through.
``enable_async=True`` (``BYTEPS_ENABLE_ASYNC``) needs the PS tier and
raises ``NotImplementedError`` (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..common import api as _api
from ..common.config import get_config
from ..ops.compression import Compression

init = _api.init
shutdown = _api.shutdown
suspend = _api.suspend
resume = _api.resume
rank = _api.rank
size = _api.size
local_rank = _api.local_rank
local_size = _api.local_size
declare = _api.declare
get_pushpull_speed = _api.get_pushpull_speed

# handle -> the tensor its result is written back into
_handles: Dict[int, torch.Tensor] = {}


def push_pull_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None, priority: int = 0,
                    compression=Compression.none) -> int:
    """Start an in-place push_pull of ``tensor``; ``synchronize`` writes
    the result back into it."""
    h = _api.push_pull_async(tensor, name=name, average=average,
                             priority=priority, compression=compression)
    _handles[h] = tensor
    return h


def push_pull_async_inplace(tensor, average=True, name=None, priority=0):
    return push_pull_async(tensor, average=average, name=name,
                           priority=priority)


def push_pull(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None, priority: int = 0,
              compression=Compression.none) -> torch.Tensor:
    """Blocking push_pull, in place; returns the tensor."""
    return synchronize(push_pull_async(tensor, average=average, name=name,
                                       priority=priority,
                                       compression=compression))


def synchronize(handle: int) -> torch.Tensor:
    """Wait for an async push_pull, write the result back into its tensor
    and return the tensor.  ValueError for an unknown or already
    synchronized handle."""
    out = _api.synchronize(handle)
    tensor = _handles.pop(handle)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def poll(handle: int) -> bool:
    return _api.poll(handle)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Wraps a torch optimizer so that ``step()`` averages gradients across
    workers first.  ``step_handles`` is the number of push_pulls the last
    step synchronized."""

    def __init__(self, optimizer: torch.optim.Optimizer, named_parameters,
                 compression, backward_passes_per_step: int = 1):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._inner = optimizer
        self._compression = compression
        self._bpps = backward_passes_per_step
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if named_parameters is not None:
            names = {p: n for n, p in named_parameters}
        else:
            names = {p: f"param.{i}.{j}"
                     for i, g in enumerate(optimizer.param_groups)
                     for j, p in enumerate(g["params"])}
        self._names = {p: "Gradient." + names.get(p, f"anon.{id(p)}")
                       for p in params}
        for p in params:
            declare(self._names[p])
        self._priority = {p: len(params) - 1 - i
                          for i, p in enumerate(params)}
        self._passes: Dict[torch.Tensor, int] = {}
        self._pending: Dict[torch.Tensor, int] = {}
        self.step_handles = 0
        for p in params:
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._grad_hook)
        # the inner optimizer's state, so schedulers keep working
        self.param_groups = optimizer.param_groups
        self.defaults = optimizer.defaults
        self.state = optimizer.state

    def _launch(self, p: torch.Tensor) -> None:
        self._pending[p] = push_pull_async(
            p.grad, average=True, name=self._names[p],
            priority=self._priority[p], compression=self._compression)

    def _grad_hook(self, p: torch.Tensor) -> None:
        if p not in self._names:
            return
        n = self._passes.get(p, 0) + 1
        self._passes[p] = n
        if n == self._bpps and p not in self._pending:
            self._launch(p)

    def synchronize(self) -> None:
        """Launch what no hook launched (a gradient set by hand), then wait
        for every push_pull of this step."""
        for p in self._names:
            if p.grad is not None and p not in self._pending:
                self._launch(p)
        self.step_handles = len(self._pending)
        for p, h in self._pending.items():
            synchronize(h)
            if self._bpps > 1:
                p.grad.div_(self._bpps)
        self._pending.clear()
        self._passes.clear()

    def step(self, closure=None):
        self.synchronize()
        return self._inner.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        """Zero the gradients; push_pulls still in flight (a backward
        without a step) are waited for and dropped first, so the next
        step starts from no handle."""
        for h in self._pending.values():
            synchronize(h)
        self._pending.clear()
        self._passes.clear()
        return self._inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         enable_async: Optional[bool] = None):
    """enable_async=None reads BYTEPS_ENABLE_ASYNC, as the reference does;
    the asynchronous mode needs the PS tier (not ported)."""
    if enable_async is None:
        enable_async = get_config(refresh=True).enable_async
    if enable_async:
        raise NotImplementedError(
            "enable_async needs the PS tier, which is not ported to "
            "byteps_tpu_torch yet (ROADMAP.md Queue 1 item 6)")
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """In-place broadcast of a state_dict or an iterable of (name, tensor)
    from root_rank."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    tensors = {name: t for name, t in items if torch.is_tensor(t)}
    if not tensors or size() == 1:
        return
    out = _api.broadcast_parameters(
        {name: t.detach() for name, t in tensors.items()}, root_rank)
    with torch.no_grad():
        for name, t in tensors.items():
            t.copy_(out[name])


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast the optimizer's state tensors and its scalar state (as
    tensors), then load it back."""
    sd = optimizer.state_dict()
    tree = {}
    for pid, pstate in sd.get("state", {}).items():
        for k, v in pstate.items():
            if torch.is_tensor(v):
                tree[f"{pid}::{k}"] = v.detach()
            elif isinstance(v, (int, float)):
                tree[f"{pid}::{k}"] = float(v)
    if not tree:
        return
    out = _api.broadcast_parameters(tree, root_rank)
    for pid, pstate in sd.get("state", {}).items():
        for k, v in list(pstate.items()):
            got = out.get(f"{pid}::{k}")
            if got is None:
                continue
            if torch.is_tensor(v):
                with torch.no_grad():
                    v.copy_(got)
            else:
                pstate[k] = type(v)(got)
    optimizer.load_state_dict(sd)


class DistributedDataParallel(torch.nn.Module):
    """Broadcasts the module's state at construction, re-broadcasts its
    buffers each forward, and averages the gradients when the backward pass
    completes (an end-of-backward engine callback queued by the first
    gradient hook), so ``loss.backward(); optimizer.step()`` needs a plain
    optimizer and no explicit ``synchronize()``.  ``auto_sync=False`` leaves
    ``synchronize()`` to the caller."""

    def __init__(self, module: torch.nn.Module, broadcast_buffers=True,
                 auto_sync: bool = True):
        super().__init__()
        self.module = module
        self.broadcast_buffers = broadcast_buffers
        self.auto_sync = auto_sync
        self.autosync_count = 0
        broadcast_parameters(self.module.state_dict(), root_rank=0)
        self._backward_cb_queued = False
        if auto_sync:
            for p in self.module.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._grad_hook)

    def _grad_hook(self, _param) -> None:
        if not self._backward_cb_queued:
            self._backward_cb_queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._on_backward_end)

    def _on_backward_end(self) -> None:
        self._backward_cb_queued = False
        self.synchronize()
        self.autosync_count += 1

    def forward(self, *args, **kwargs):
        self._backward_cb_queued = False
        if self.broadcast_buffers and size() > 1:
            broadcast_parameters(dict(self.module.named_buffers()),
                                 root_rank=0)
        return self.module(*args, **kwargs)

    def synchronize(self) -> None:
        grads = {f"DDP.Gradient.{n}": p.grad
                 for n, p in self.module.named_parameters()
                 if p.grad is not None}
        if not grads:
            return
        out = _api.push_pull_tree(grads, average=True,
                                  leaf_names=sorted(grads))
        with torch.no_grad():
            for n, p in self.module.named_parameters():
                key = f"DDP.Gradient.{n}"
                if key in out:
                    p.grad.copy_(out[key])


# Imported last: these modules import this module's push_pull surface.
from .cross_barrier import CrossBarrier  # noqa: E402
from .fp16 import (  # noqa: E402
    HalfPrecisionDistributedOptimizer, broadcast_fp16_parameters)
