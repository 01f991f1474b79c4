"""Framework-level compression: the ``Compression`` casts.

Counterpart of ``byteps_tpu/ops/compression.py``: a dtype cast applied to
each gradient before communication and undone after.  ``Compression.fp16``
maps to bfloat16 as in the JAX package; ``Compression.f16`` is IEEE half.
"""

from __future__ import annotations

import torch


class Compressor:
    """A bidirectional dtype cast around communication."""

    def compress(self, tensor: torch.Tensor):
        """Returns (compressed_tensor, ctx); ctx is what decompress needs."""
        raise NotImplementedError

    def decompress(self, tensor: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    def compress(self, tensor):
        return tensor, None

    def decompress(self, tensor, ctx):
        return tensor


class CastCompressor(Compressor):
    def __init__(self, wire_dtype: torch.dtype):
        self.wire_dtype = wire_dtype

    def compress(self, tensor):
        if tensor.is_floating_point():
            return tensor.to(self.wire_dtype), tensor.dtype
        return tensor, None

    def decompress(self, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class Compression:
    """Namespace matching the reference API: Compression.fp16 etc."""

    none = NoneCompressor()
    fp16 = CastCompressor(torch.bfloat16)   # as the JAX package: bf16
    f16 = CastCompressor(torch.float16)     # strict IEEE half
    bf16 = CastCompressor(torch.bfloat16)
