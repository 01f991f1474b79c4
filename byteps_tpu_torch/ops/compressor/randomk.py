"""Random-k sparsification: k elements at seeded-pseudorandom indices.

Counterpart of ``byteps_tpu/ops/compressor/randomk.py``: k lanes of
xorshift32 each map to an index by the same ``u * n`` truncation, so the
selection replays the JAX package's bit for bit.  Indices may collide (as
in the reference); decompress scatter-adds.  The state is the k-lane PRNG,
advanced once per compress.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .base import InterCompressor, Payload, State, rng_uniform, seed_state
from .topk import scatter_add


class RandomkCompressor(InterCompressor):
    name = "randomk"

    def __init__(self, k: int, seed: int = 2020):
        if k <= 0:
            raise ValueError(f"randomk requires k > 0, got {k}")
        self.k = k
        self.seed = seed

    def init_state(self, n: int, dtype=torch.float32,
                   device: Optional[torch.device] = None) -> State:
        return {"rng": seed_state(self.seed, self.k, device)}

    def compress(self, buf: torch.Tensor, state: State
                 ) -> Tuple[Payload, State]:
        n = buf.numel()
        k = min(self.k, n)
        u, rng = rng_uniform(state["rng"])
        idx = (u[:k] * n).to(torch.int32).clamp_max(n - 1)
        vals = buf.float()[idx.long()]
        return {"idx": idx, "val": vals}, {"rng": rng}

    def decompress(self, payload: Payload, n: int,
                   dtype=torch.float32) -> torch.Tensor:
        return scatter_add(payload, n, dtype)

    def payload_shapes(self, n: int, dtype=torch.float32):
        k = min(self.k, n)
        return {"idx": ((k,), torch.int32), "val": ((k,), torch.float32)}
