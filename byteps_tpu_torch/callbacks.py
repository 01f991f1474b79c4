"""Training callbacks: the reference's Keras callback suite as plain hooks.

Counterpart of ``byteps_tpu/callbacks.py``: ``BroadcastGlobalVariables``,
``MetricAverage`` and the learning-rate warmup (a schedule, ``step ->
lr``, with the values of the JAX package's optax schedule), the
error-feedback LR rescale, and linear LR scaling by world size.

    cbs = [BroadcastGlobalVariablesCallback(0), MetricAverageCallback()]
    for cb in cbs: state = cb.on_train_begin(state)
    ...
    for cb in cbs: metrics = cb.on_epoch_end(metrics)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

Tree = Any
Schedule = Callable[[int], float]


class Callback:
    def on_train_begin(self, state: Tree) -> Tree:
        return state

    def on_epoch_end(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        return metrics


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial state from root_rank to every worker."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state: Tree) -> Tree:
        from .common.api import broadcast_parameters
        return broadcast_parameters(state, self.root_rank)


class MetricAverageCallback(Callback):
    """Average epoch metrics across workers before reporting."""

    def on_epoch_end(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        from .common.api import push_pull
        return {k: float(push_pull(torch.as_tensor(v, dtype=torch.float32),
                                   name=f"metric.{k}", average=True))
                for k, v in metrics.items()}


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda step: init
    return lambda step: init + (end - init) * min(max(step / steps, 0.0),
                                                  1.0)


def warmup_schedule(base_lr: float, warmup_steps: int,
                    after: Optional[Schedule] = None,
                    warmup_init_factor: float = 1.0 / 3) -> Schedule:
    """The LearningRateWarmup callback as a schedule: ramp from
    base_lr * warmup_init_factor to base_lr over warmup_steps, then
    base_lr, or ``after(step - warmup_steps)`` (optax.join_schedules)."""
    ramp = _linear(base_lr * warmup_init_factor, base_lr, warmup_steps)
    if after is None:
        return lambda step: ramp(step) if step < warmup_steps else base_lr
    return lambda step: (ramp(step) if step < warmup_steps
                         else after(step - warmup_steps))


class EFLRScaleCallback(Callback):
    """Keep error feedback's carried error consistent with a changing
    learning rate: ``on_step(step, state)`` applies the one-shot
    ``prev_lr / new_lr`` rescale (``ops.compressor.set_lr_scale``) to the
    compressor state whenever the schedule's LR changes between two
    positive values.

        opt.compression_state = cb.on_step(step, opt.compression_state)
    """

    def __init__(self, schedule: Schedule):
        self.schedule = schedule
        self._prev: Optional[float] = None

    def on_step(self, step: int, state: Tree) -> Tree:
        from .ops.compressor import set_lr_scale
        lr = float(self.schedule(step))
        if (self._prev is not None and self._prev > 0 and lr > 0
                and lr != self._prev):
            state = set_lr_scale(state, self._prev / lr)
        if lr > 0:
            self._prev = lr
        return state


def scaled_lr(base_lr: float, size: Optional[int] = None) -> float:
    """Linear LR scaling by world size."""
    if size is None:
        from .common.api import size as _size
        size = _size()
    return base_lr * size
