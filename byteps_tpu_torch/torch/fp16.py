"""Half-precision distributed optimizer: fp16/bf16 wire, fp32 master weights.

Counterpart of ``byteps_tpu/torch/fp16.py`` (the reference's
``_HalfPrecisionDistributedOptimizer``, byteps/misc/imagenet18): the model
holds half-precision parameters, gradients travel the wire cast by
``Compression.fp16`` (bf16, as in the JAX package), an fp32 master copy of
every parameter takes the updates, and the masters are cast back into the
model after each step.  A dynamic loss scaler (halve on overflow and skip
the update, grow after ``scale_growth_interval`` clean steps) keeps small
gradients representable; a static scale is available too.  Every
gradient's push_pull is dispatched before the first is synchronized.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..ops.compression import Compression
from . import push_pull_async, synchronize, size


class HalfPrecisionDistributedOptimizer:
    """Distributed optimizer for a half-precision model with fp32 masters.

    Usage::

        model = Net().to(torch.float16)          # or bfloat16
        opt = HalfPrecisionDistributedOptimizer(
            model, lambda params: torch.optim.SGD(params, lr=0.1),
            loss_scale=1024.0)                    # or "dynamic"
        for x, y in data:
            opt.zero_grad()
            loss = criterion(model(x.half()), y)
            opt.scale_loss(loss).backward()
            opt.step()
    """

    def __init__(self, model: torch.nn.Module,
                 optimizer_factory: Callable[[List[torch.Tensor]],
                                             torch.optim.Optimizer],
                 compression=Compression.fp16,
                 loss_scale: object = "dynamic",
                 scale_growth_interval: int = 200,
                 named_parameters: Optional[Iterable[Tuple[str,
                                                           torch.Tensor]]]
                 = None):
        self._model = model
        self._compression = compression
        named = list(named_parameters) if named_parameters is not None \
            else list(model.named_parameters())
        from collections import Counter
        dups = {n for n, c in Counter(k for k, _ in named).items() if c > 1}
        if dups:
            raise ValueError(f"duplicate parameter names: {sorted(dups)}")
        self._half_params: List[torch.Tensor] = [p for _, p in named]
        self._names: Dict[int, str] = {id(p): n for n, p in named}
        # fp32 master copies; the inner optimizer owns them.
        self._master_params: List[torch.nn.Parameter] = [
            torch.nn.Parameter(p.detach().float().clone())
            for p in self._half_params]
        self._inner = optimizer_factory(self._master_params)
        # Loss scaling: static, or "dynamic".
        self._dynamic = loss_scale == "dynamic"
        self._scale = 2.0 ** 16 if self._dynamic else float(loss_scale)
        self._growth_interval = scale_growth_interval
        self._good_steps = 0
        self.steps_skipped = 0  # overflow-skipped steps (introspection)

    # -- loss scaling -------------------------------------------------------
    @property
    def loss_scale(self) -> float:
        return self._scale

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self._scale

    # -- optimizer surface --------------------------------------------------
    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._half_params:
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()

    @property
    def param_groups(self):
        return self._inner.param_groups

    def state_dict(self):
        return {"inner": self._inner.state_dict(), "scale": self._scale,
                "masters": [p.detach().clone()
                            for p in self._master_params]}

    def load_state_dict(self, sd):
        self._inner.load_state_dict(sd["inner"])
        self._scale = sd["scale"]
        with torch.no_grad():
            for m, saved in zip(self._master_params, sd["masters"]):
                m.copy_(saved)
        self._copy_masters_to_model()

    def step(self, closure=None) -> None:
        """push_pull the half-precision grads (compressed wire), unscale
        into the fp32 masters, step the inner optimizer, cast masters back."""
        if closure is not None:
            raise ValueError("closure is not supported in fp16 mode")
        # Dispatch every gradient first (overlap), then synchronize.
        handles = []
        for p in self._half_params:
            if p.grad is None:
                continue
            name = "Gradient." + self._names[id(p)]
            h = push_pull_async(p.grad, average=True, name=name,
                                compression=self._compression)
            handles.append((p, h))
        for _p, h in handles:
            synchronize(h)
        # Unscale into masters; detect overflow for the dynamic scaler.
        inv = 1.0 / self._scale
        overflow = False
        with torch.no_grad():
            for half_p, master in zip(self._half_params,
                                      self._master_params):
                if half_p.grad is None:
                    master.grad = None
                    continue
                # copy=True: for params kept in fp32 (norm layers etc.)
                # .float() would alias p.grad and mul_ would mutate the
                # model's gradient in place.
                g32 = half_p.grad.detach().to(dtype=torch.float32,
                                              copy=True).mul_(inv)
                if not torch.isfinite(g32).all():
                    overflow = True
                master.grad = g32
        if overflow:
            self.steps_skipped += 1
            if self._dynamic:
                self._scale = max(self._scale / 2.0, 1.0)
                self._good_steps = 0
            return  # skip the update entirely, matching AMP semantics
        self._inner.step()
        if self._dynamic:
            self._good_steps += 1
            if self._good_steps >= self._growth_interval:
                self._scale *= 2.0
                self._good_steps = 0
        self._copy_masters_to_model()

    def _copy_masters_to_model(self) -> None:
        with torch.no_grad():
            for half_p, master in zip(self._half_params,
                                      self._master_params):
                half_p.copy_(master.to(half_p.dtype))


def broadcast_fp16_parameters(opt: HalfPrecisionDistributedOptimizer,
                              root_rank: int = 0) -> None:
    """Broadcast the fp32 masters from root and cast them into the half
    model, so all workers start bit-identical."""
    from . import broadcast_parameters
    if size() == 1:
        return
    broadcast_parameters(
        {f"master.{i}": p for i, p in enumerate(opt._master_params)},
        root_rank)
    opt._copy_masters_to_model()
