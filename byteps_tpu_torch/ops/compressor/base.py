"""Inter-node gradient compressor interface (level 2 of the two-level design).

Counterpart of ``byteps_tpu/ops/compressor/base.py``, with the same
functional contract:

    payload, state' = compressor.compress(buf, state)
    buf'            = compressor.decompress(payload, n)

  - ``buf`` is a flat float32/bfloat16 vector: one <= 4 MiB bucket.
  - ``payload`` is a dict of fixed-shape tensors, the wire format;
    ``payload_bytes()`` is its size.  ``decompress`` also takes payloads
    with leading batch dimensions, [W, ...] -> [W, n]: the W payloads that
    an all-gather brings in, the JAX package's ``vmap`` written out.
  - ``state`` carries the PRNG lanes and the decorators' buffers (error
    feedback, momentum) as tensors on the bucket's device.

The xorshift32 generator replays the JAX package's bit for bit.  Its lanes
are int32 tensors holding the uint32 bits; the arithmetic runs in int64
masked to 32 bits (an arithmetic right shift of int32 would smear the sign
bit into ``x >> 17``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .bitpack import _MASK32, _as_int32, _as_uint

Payload = Dict[str, torch.Tensor]
State = Any


class InterCompressor:
    """Base class.  Subclasses are stateless Python objects; all mutable
    state flows through ``state``."""

    name: str = "base"
    #: True if the merged (summed) gradient is re-compressed before it is
    #: pulled back, as the reference's bidirectional compressors do.
    bidirectional: bool = False

    def init_state(self, n: int, dtype=torch.float32,
                   device: Optional[torch.device] = None) -> State:
        """Per-bucket state for a bucket of n elements, on ``device``."""
        del n, dtype, device
        return ()

    def compress(self, buf: torch.Tensor, state: State
                 ) -> Tuple[Payload, State]:
        raise NotImplementedError

    def decompress(self, payload: Payload, n: int,
                   dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError

    def payload_bytes(self, n: int, dtype=torch.float32) -> int:
        """Wire bytes for an n-element bucket (the compression ratio and
        the expansion gate in reduce.py)."""
        import math
        return sum(math.prod(int(x) for x in s) * d.itemsize
                   for s, d in self.payload_shapes(n, dtype).values())

    def payload_shapes(self, n: int, dtype=torch.float32
                       ) -> Dict[str, tuple]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Deterministic PRNG: xorshift32, vectorised, as the JAX package has it.
# ---------------------------------------------------------------------------
def _xorshift32_u(x: torch.Tensor) -> torch.Tensor:
    x = x ^ ((x << 13) & _MASK32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & _MASK32)


def xorshift32(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step.  state: int32 lanes (uint32 bits), nonzero."""
    return _as_int32(_xorshift32_u(_as_uint(state)))


def rng_uniform(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance the per-lane PRNG; return (u in [0,1) float32, new_state)."""
    s = _xorshift32_u(_as_uint(state))
    # 24 mantissa-safe bits.
    u = (s >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u, _as_int32(s)


def seed_state(seed: int, n: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """n independent nonzero lanes from a scalar seed (splitmix-style lane
    spreading, then one warmup round)."""
    lanes = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    s = (lanes * 2654435761 + ((seed | 1) & _MASK32)) & _MASK32
    s = torch.where(s == 0, torch.full_like(s, 0x9E3779B9), s)
    return _as_int32(_xorshift32_u(s))
