"""Error-feedback and momentum decorators.

Counterpart of ``byteps_tpu/ops/compressor/decorators.py``: the reference's
decorator chain (error feedback: grad += e; c = Compress(grad);
e = grad - Decompress(c); Nesterov momentum: m = mu*m + g; g += mu*m),
with the buffers in the compressor ``state``.

The vanilla-EF learning-rate rescale is an ``lr_scale`` entry in the state:
when the training LR changes, call ``set_lr_scale(state, prev_lr / new_lr)``
between steps (for a ``DistributedOptimizer``:
``opt.compression_state = set_lr_scale(opt.compression_state, r)``).  The
scale is consumed by the NEXT compress and resets to 1.0, the reference's
one-shot ``pre_lr = cur_lr``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .base import InterCompressor, Payload, State


class ErrorFeedback(InterCompressor):
    """Vanilla error feedback around an inner compressor."""

    name = "ef"

    def __init__(self, inner: InterCompressor):
        self.inner = inner
        self.bidirectional = inner.bidirectional

    def init_state(self, n: int, dtype=torch.float32,
                   device: Optional[torch.device] = None) -> State:
        return {"inner": self.inner.init_state(n, dtype, device),
                "error": torch.zeros((n,), dtype=torch.float32,
                                     device=device),
                "lr_scale": torch.ones((), dtype=torch.float32,
                                       device=device)}

    def compress(self, buf: torch.Tensor, state: State
                 ) -> Tuple[Payload, State]:
        # reference: UpdateGradient = grad += (pre_lr/cur_lr) * error
        corrected = buf.float() + state["lr_scale"] * state["error"]
        payload, inner_state = self.inner.compress(corrected, state["inner"])
        # reference: UpdateError = e = grad - Decompress(c)
        err = corrected - self.inner.decompress(payload, corrected.numel())
        # One-shot, like the reference's `pre_lr = cur_lr`.
        return payload, {"inner": inner_state, "error": err,
                         "lr_scale": torch.ones_like(state["lr_scale"])}

    def decompress(self, payload: Payload, n: int,
                   dtype=torch.float32) -> torch.Tensor:
        return self.inner.decompress(payload, n, dtype)

    def payload_shapes(self, n: int, dtype=torch.float32):
        return self.inner.payload_shapes(n, dtype)


def set_lr_scale(state: State, scale) -> State:
    """A copy of ``state`` (nested dicts, lists and tuples) with every
    ErrorFeedback ``lr_scale`` entry multiplied by ``scale`` =
    prev_lr / new_lr, consumed once by the next compress.  Multiplicative,
    so consecutive calls with no compress in between compose."""
    def walk(node, under: bool):
        if isinstance(node, dict):
            return {k: walk(v, under or k == "lr_scale")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, under) for v in node)
        if under and isinstance(node, torch.Tensor):
            return node * torch.tensor(scale, dtype=torch.float32,
                                       device=node.device)
        return node
    return walk(state, False)


class NesterovMomentum(InterCompressor):
    """Nesterov momentum applied before (EF +) compression; worker-only."""

    name = "momentum"

    def __init__(self, inner: InterCompressor, mu: float = 0.9):
        self.inner = inner
        self.mu = mu
        self.bidirectional = inner.bidirectional

    def init_state(self, n: int, dtype=torch.float32,
                   device: Optional[torch.device] = None) -> State:
        return {"inner": self.inner.init_state(n, dtype, device),
                "mom": torch.zeros((n,), dtype=torch.float32, device=device)}

    def compress(self, buf: torch.Tensor, state: State
                 ) -> Tuple[Payload, State]:
        g = buf.float()
        m = self.mu * state["mom"] + g          # m = mu*m + g
        g = g + self.mu * m                     # g += mu*m  (Nesterov)
        payload, inner_state = self.inner.compress(g, state["inner"])
        return payload, {"inner": inner_state, "mom": m}

    def decompress(self, payload: Payload, n: int,
                   dtype=torch.float32) -> torch.Tensor:
        return self.inner.decompress(payload, n, dtype)

    def payload_shapes(self, n: int, dtype=torch.float32):
        return self.inner.payload_shapes(n, dtype)
