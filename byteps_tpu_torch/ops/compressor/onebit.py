"""Onebit (sign) compression: 32:1, optionally scaled.

Counterpart of ``byteps_tpu/ops/compressor/onebit.py``: keep only the sign
of each element, packed 32 to a word by the sign kernels of ``bitpack``,
with an optional scale = mean(|x|) so the reconstruction is
``scale * sign(x)`` instead of +-1.  Bidirectional: the merged gradient is
re-compressed before the pull leg, as the reference server does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .base import InterCompressor, Payload, State
from .bitpack import pack_signs, unpack_signs, words_len


class OnebitCompressor(InterCompressor):
    name = "onebit"
    bidirectional = True

    def __init__(self, scaled: bool = True):
        self.scaled = scaled

    def compress(self, buf: torch.Tensor, state: State
                 ) -> Tuple[Payload, State]:
        n = buf.numel()
        # sign bit: 1 where x < 0 (zero counts as +, matching the
        # sign(0) = +1 reconstruction below).
        words = pack_signs(buf)
        if self.scaled:
            scale = buf.float().abs().sum() / max(n, 1)
        else:
            scale = torch.ones((), dtype=torch.float32, device=buf.device)
        return {"bits": words, "scale": scale[None]}, state

    def decompress(self, payload: Payload, n: int,
                   dtype=torch.float32) -> torch.Tensor:
        sign = unpack_signs(payload["bits"], n)       # +-1 float32
        return (sign * payload["scale"]).to(dtype)

    def payload_shapes(self, n: int, dtype=torch.float32):
        return {"bits": ((words_len(n),), torch.int32),
                "scale": ((1,), torch.float32)}
