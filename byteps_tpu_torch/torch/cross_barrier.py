"""Torch cross-barrier: overlap gradient sync with the NEXT step's forward.

Counterpart of ``byteps_tpu/torch/cross_barrier.py`` (the reference's
ByteScheduler design): backward hooks dispatch each gradient's push_pull
at once, a poller thread completes them out of band and applies a
PER-PARAMETER optimizer update the moment that gradient arrives, and
forward pre-hooks on each module wait on per-parameter locks — so step
N+1's forward for early layers runs while step N's late-layer gradients
are still in flight.

  - Per-parameter updates use a private single-parameter instance of the
    caller's own optimizer class (same hyperparameters, re-read from the
    caller's param groups at every update, so LR schedules apply).
  - Gradient hooks are ``register_post_accumulate_grad_hook``.
  - Communication is the port's eager handle API (``push_pull_async``,
    ``poll``, ``synchronize`` of ``byteps_tpu_torch.torch``, on
    ``torch.distributed``), or ``comm=(dispatch, wait[, poll])`` injected
    so tests can shape the completion timeline.

On the card, the poller is a second host thread that launches the update
kernels.  It selects the parameters' device (``torch.cuda.set_device``)
and enqueues every update on the stream that was current on the
constructing thread for that device when ``CrossBarrier`` was built: the
stream the caller's forward and backward run on (the default stream,
unless the caller built it inside ``torch.cuda.stream(s)``).  The
per-parameter lock orders the host; that stream orders the device, so the
next forward's kernels run after the update they waited for.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops.compression import Compression


class _CrossBarrierOptimizer:
    """Optimizer facade whose updates are applied per-parameter by a poller
    thread as each gradient's push_pull completes."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 comm: Optional[Tuple[Callable, ...]] = None):
        from . import poll, push_pull_async, synchronize  # eager surface
        self._model = model
        self._inner = optimizer
        self._compression = compression
        self._bpps = max(1, backward_passes_per_step)
        self._dispatch = comm[0] if comm else (
            lambda p, name: push_pull_async(p.grad, average=True, name=name,
                                            compression=compression))
        self._wait = comm[1] if comm else synchronize
        self._poll = (comm[2] if comm and len(comm) > 2
                      else (poll if comm is None else (lambda h: True)))
        if named_parameters is not None:
            self._names = {p: n for n, p in named_parameters}
        else:
            self._names = {p: f"param.{i}.{j}"
                           for i, g in enumerate(optimizer.param_groups)
                           for j, p in enumerate(g["params"])}
        # Inner-state passthrough: LR schedulers attach to the inner
        # optimizer, whose groups _apply_update re-reads at every update.
        self.param_groups = optimizer.param_groups
        self.defaults = optimizer.defaults
        self.state = optimizer.state

        self._param_opt: Dict[torch.Tensor, torch.optim.Optimizer] = {}
        self._locks: Dict[torch.Tensor, threading.Lock] = {}
        self._accum: Dict[torch.Tensor, int] = {}
        self._src_group: Dict[torch.Tensor, dict] = {}
        ctor_args = set(
            inspect.signature(type(optimizer).__init__).parameters)
        for group in optimizer.param_groups:
            # Groups can carry keys the constructor does not take (AdamW's
            # decoupled_weight_decay): keep its real hyperparameters.
            hyper = {k: v for k, v in group.items()
                     if k != "params" and k in ctor_args}
            for p in group["params"]:
                self._param_opt[p] = type(optimizer)([p], **hyper)
                self._src_group[p] = group
                self._locks[p] = threading.Lock()
                self._accum[p] = 0
        # The device and stream the poller launches on (module docstring).
        self._device = next((p.device for p in self._param_opt
                             if p.device.type == "cuda"), None)
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._device is not None else None)
        self.step_count = 0
        self._sync_events: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._closed = False

        self._hook_handles = []
        for p in self._param_opt:
            if p.requires_grad:
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(self._grad_ready))
        self._install_forward_hooks()
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="bps-cross-barrier")
        self._poller.start()

    # -- backward side ------------------------------------------------------
    def _grad_ready(self, p: torch.Tensor) -> None:
        """Engine hook: p's gradient for this backward is final — ship it."""
        self._accum[p] += 1
        if self._accum[p] < self._bpps:
            return
        self._accum[p] = 0
        if self._bpps > 1:
            with torch.no_grad():
                p.grad.div_(self._bpps)
        name = "CrossBarrier.Gradient." + self._names.get(p, f"anon.{id(p)}")
        self._locks[p].acquire()  # released by the poller after the update
        try:
            handle = self._dispatch(p, name)
        except Exception:
            self._locks[p].release()
            raise
        self._sync_events.put((p, handle))

    # -- poller side --------------------------------------------------------
    def _poll_loop(self) -> None:
        """Complete push_pulls out of band, apply that one parameter's
        update at once and release its forward lock.  A handle that is not
        finished is requeued, never blocked on: one slow gradient must not
        hold up the updates of gradients that completed after it."""
        if self._device is not None:
            torch.cuda.set_device(self._device)
        stall_marker = None   # first requeued item of a no-progress cycle
        while True:
            item = self._sync_events.get()
            if item is None:
                return
            p, handle = item
            try:
                done = self._poll(handle)
            except Exception as e:
                self._errors.append(e)
                self._locks[p].release()
                continue
            if not done:                 # still in flight: lock stays held
                self._sync_events.put(item)
                if stall_marker is None:
                    stall_marker = item
                elif stall_marker is item:
                    # A full pass over the queue completed nothing: yield.
                    time.sleep(0.001)
                continue
            stall_marker = None
            try:
                if self._stream is None:
                    self._wait(handle)   # averaged grad lands in p.grad
                    self._apply_update(p)
                else:
                    with torch.cuda.stream(self._stream):
                        self._wait(handle)
                        self._apply_update(p)
            except Exception as e:       # surfaced by step()/close()
                self._errors.append(e)
            finally:
                self._locks[p].release()

    def _apply_update(self, p: torch.Tensor) -> None:
        po = self._param_opt[p]
        # Re-read the hyperparameters from the caller's (shared) group: an
        # LR scheduler mutates group["lr"] on the inner optimizer.
        src = self._src_group[p]
        po.param_groups[0].update(
            {k: v for k, v in src.items() if k != "params"})
        po.step()
        with torch.no_grad():
            p.grad.zero_()

    # -- forward side -------------------------------------------------------
    def _install_forward_hooks(self) -> None:
        """Every module with parameters of its own waits on their locks
        before its forward: only the layer whose update is still in flight
        blocks, while earlier layers run."""
        def pre_forward(mod, _inputs):
            for p in mod.parameters(recurse=False):
                lk = self._locks.get(p)
                if lk is not None:
                    with lk:
                        pass
        for mod in self._model.modules():
            if next(mod.parameters(recurse=False), None) is not None:
                self._hook_handles.append(
                    mod.register_forward_pre_hook(pre_forward))

    # -- optimizer facade ---------------------------------------------------
    def step(self, closure=None) -> None:
        """A scheduling boundary, not a barrier: the poller applies the
        updates; the next forward's pre-hooks enforce the dependencies."""
        del closure
        self.step_count += 1
        if self._errors:
            raise self._errors.pop(0)

    def zero_grad(self, set_to_none: bool = False) -> None:
        """No-op by design: the poller zeroes each grad right after its
        update (set_to_none would race the poller's in-place writes)."""
        del set_to_none

    def synchronize(self) -> None:
        """Block until every in-flight gradient has been applied (end of
        training, or before a checkpoint)."""
        for lk in self._locks.values():
            with lk:
                pass
        if self._errors:
            raise self._errors.pop(0)

    def state_dict(self) -> Dict[str, Any]:
        self.synchronize()
        return {"per_param": [o.state_dict()
                              for o in self._param_opt.values()],
                "step_count": self.step_count}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for o, s in zip(self._param_opt.values(), sd["per_param"]):
            o.load_state_dict(s)
        self.step_count = sd.get("step_count", 0)

    def close(self) -> None:
        """Drain, stop the poller, and detach every hook this wrapper
        installed (a backward after close() would otherwise dispatch into a
        dead queue and deadlock the next forward).  Teardown runs even when
        the drain re-raises a recorded error."""
        if not self._closed:
            self._closed = True
            try:
                self.synchronize()
            finally:
                for h in self._hook_handles:
                    h.remove()
                self._hook_handles.clear()
                self._sync_events.put(None)
                self._poller.join(timeout=10)


def CrossBarrier(model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 comm: Optional[Tuple[Callable, ...]] = None
                 ) -> _CrossBarrierOptimizer:
    """Wrap ``optimizer`` so gradient sync crosses the step barrier (the
    reference's factory, same call shape)."""
    return _CrossBarrierOptimizer(model, optimizer, named_parameters,
                                  compression, backward_passes_per_step,
                                  comm)
