"""Cross-barrier pipelining: keep the device queue full across steps.

Counterpart of ``byteps_tpu/parallel/cross_barrier.py``.  The reference
removes the host-side barrier between steps (ByteScheduler's credit
system): steps are dispatched eagerly, the host runs ahead of the device,
and a loss is only waited for when it is read.  CUDA launches are
asynchronous as JAX's dispatch is, so the same discipline carries over:

  - ``submit`` dispatches one step and returns at once,
  - ``max_in_flight`` bounds the run-ahead (credits, in step units): while
    more than that many losses are unresolved, the oldest is resolved with
    ``.item()``, which waits for its step,
  - ``losses()`` are floats in step order.

The state differs from the reference's.  There the step is functional,
``step(params, opt_state, batch) -> (params, opt_state, loss)``, and the
driver threads the new state through.  The port's step
(``build_train_step``) updates the parameters and the optimizer's state in
place, ``step(params, batch) -> loss``, so the driver holds ``params``
only to hand them back: ``finish()`` waits for the device and returns
them, and the optimizer's state lives in the optimizer.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Tuple

import torch

Tree = Any


class CrossBarrierDriver:
    """Run an in-place train step without host-side barriers.

    step(params, batch) -> loss

    Usage:
        drv = CrossBarrierDriver(step, params, max_in_flight=2)
        for batch in data:
            drv.submit(batch)        # returns immediately
        params = drv.finish()
        losses = drv.losses()        # floats, synchronized
    """

    def __init__(self, step: Callable, params: Tree, max_in_flight: int = 2):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self._step = step
        self._params = params
        self._max = max_in_flight
        self._pending: collections.deque = collections.deque()
        self._losses: list = []

    def submit(self, batch: Tree) -> None:
        """Dispatch one training step; blocks only when more than
        ``max_in_flight`` steps' losses are unresolved (the credit gate)."""
        self._pending.append(self._step(self._params, batch))
        while len(self._pending) > self._max:
            # Resolving the oldest loss waits for that step's completion.
            self._losses.append(self._pending.popleft().item())

    def finish(self) -> Tree:
        """Drain the queue and wait for the device; returns the params."""
        while self._pending:
            self._losses.append(self._pending.popleft().item())
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return self._params

    def losses(self) -> list:
        return list(self._losses)

    @property
    def state(self) -> Tree:
        """The params, possibly still being updated on the device."""
        return self._params


def run_cross_barrier(step: Callable, params: Tree, batches: Iterable,
                      max_in_flight: int = 2) -> Tuple[Tree, list]:
    """Train over ``batches`` with cross-barrier pipelining; returns
    (params, losses)."""
    drv = CrossBarrierDriver(step, params, max_in_flight)
    for b in batches:
        drv.submit(b)
    return drv.finish(), drv.losses()
