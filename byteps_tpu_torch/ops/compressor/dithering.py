"""Stochastic (dithered) quantization.

Counterpart of ``byteps_tpu/ops/compressor/dithering.py``: normalise by
max-norm or L2-norm, map magnitudes onto s quantization levels with a
*linear* or *natural* (power-of-two) partition, round stochastically so the
quantizer is unbiased, and ship sign + level.  The wire format is the JAX
package's: levels packed fixed-width at b = ceil(log2(s+1)) bits
(``bitpack.pack_levels``), the sign stream through the sign kernels, and
the norm.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .base import InterCompressor, Payload, State, rng_uniform, seed_state
from .bitpack import (level_words_len, pack_levels, pack_signs,
                      unpack_levels, unpack_signs, words_len)


class DitheringCompressor(InterCompressor):
    name = "dithering"

    def __init__(self, s: int = 127, seed: int = 2020,
                 partition: str = "linear", normalize: str = "max"):
        if not (0 < s <= 127):
            raise ValueError(f"dithering levels must be in (0,127], got {s}")
        if partition not in ("linear", "natural"):
            raise ValueError(f"unknown partition {partition!r}")
        if normalize not in ("max", "l2"):
            raise ValueError(f"unknown normalize {normalize!r}")
        self.s = s
        self.seed = seed
        self.partition = partition
        self.normalize = normalize

    def init_state(self, n: int, dtype=torch.float32,
                   device: Optional[torch.device] = None) -> State:
        return {"rng": seed_state(self.seed, n, device)}

    def _levels(self, device) -> torch.Tensor:
        """Quantization points in [0,1], length s+1 (level 0 == 0)."""
        s = self.s
        if self.partition == "linear":
            return torch.arange(s + 1, dtype=torch.float32,
                                device=device) / s
        # natural: 0, 2^-(s-1), ..., 2^-1, 2^0 -- denser near zero.
        pts = 2.0 ** torch.arange(-(s - 1), 1, dtype=torch.float32,
                                  device=device)
        return torch.cat([pts.new_zeros(1), pts])

    def compress(self, buf: torch.Tensor, state: State
                 ) -> Tuple[Payload, State]:
        n = buf.numel()
        x = buf.float()
        if self.normalize == "max":
            norm = x.abs().max()
        else:
            norm = (x * x).sum().sqrt()
        norm = norm.clamp_min(torch.finfo(torch.float32).tiny)
        mag = x.abs() / norm                         # in [0, 1]
        levels = self._levels(x.device)              # [s+1] ascending
        # Bracket [levels[j], levels[j+1]] containing mag, then round
        # stochastically: P(up) = (mag - lo) / (hi - lo)  -> unbiased.
        j = (torch.searchsorted(levels, mag, right=True) - 1).clamp(
            0, self.s - 1)
        lo = levels[j]
        hi = levels[j + 1]
        p_up = torch.where(hi > lo, (mag - lo) / (hi - lo).clamp_min(1e-30),
                           torch.zeros_like(mag))
        u, rng = rng_uniform(state["rng"][:n])
        level = j + (u < p_up)
        return ({"level_words": pack_levels(level, self.s),
                 "signs": pack_signs(x),
                 "norm": norm[None]},
                {"rng": torch.cat([rng, state["rng"][n:]])})

    def decompress(self, payload: Payload, n: int,
                   dtype=torch.float32) -> torch.Tensor:
        levels = self._levels(payload["norm"].device)
        mag = levels[unpack_levels(payload["level_words"], n, self.s).long()]
        sign = unpack_signs(payload["signs"], n)      # +-1 float32
        return (sign * mag * payload["norm"]).to(dtype)

    def payload_shapes(self, n: int, dtype=torch.float32):
        return {"level_words": ((level_words_len(n, self.s),), torch.int32),
                "signs": ((words_len(n),), torch.int32),
                "norm": ((1,), torch.float32)}
