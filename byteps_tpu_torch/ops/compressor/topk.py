"""Top-k sparsification: keep the k largest-magnitude elements.

Counterpart of ``byteps_tpu/ops/compressor/topk.py``: ``torch.topk`` on
|x| where the JAX package uses ``lax.top_k``; the wire format is a (k,)
int32 index array + a (k,) value array.  Among equal magnitudes the two
may pick different indices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .base import InterCompressor, Payload, State


def scatter_add(payload: Payload, n: int, dtype) -> torch.Tensor:
    """Sparse (idx, val) payloads [..., k] -> dense [..., n]."""
    val = payload["val"]
    out = val.new_zeros(val.shape[:-1] + (n,))
    return out.scatter_add_(-1, payload["idx"].long(), val).to(dtype)


class TopkCompressor(InterCompressor):
    name = "topk"

    def __init__(self, k: int):
        if k <= 0:
            raise ValueError(f"topk requires k > 0, got {k}")
        self.k = k

    def compress(self, buf: torch.Tensor, state: State
                 ) -> Tuple[Payload, State]:
        k = min(self.k, buf.numel())
        x = buf.float()
        idx = torch.topk(x.abs(), k).indices
        return {"idx": idx.to(torch.int32), "val": x[idx]}, state

    def decompress(self, payload: Payload, n: int,
                   dtype=torch.float32) -> torch.Tensor:
        # Indices are unique (top-k), so scatter-add == scatter.
        return scatter_add(payload, n, dtype)

    def payload_shapes(self, n: int, dtype=torch.float32):
        k = min(self.k, n)
        return {"idx": ((k,), torch.int32), "val": ((k,), torch.float32)}
