"""Inter-node gradient compression (level 2).

Counterpart of ``byteps_tpu/ops/compressor/``: the onebit, topk, randomk
and dithering compressors; the error-feedback and Nesterov-momentum
decorators; the string-kwargs registry; and the compressed collective
reduction.  The sign streams of onebit and dithering go through the
hand-written Hopper kernels of ``bitpack`` (``csrc/bitpack.cu``).
"""

from .base import (InterCompressor, Payload, State, xorshift32, rng_uniform,
                   seed_state)
from .onebit import OnebitCompressor
from .topk import TopkCompressor
from .randomk import RandomkCompressor
from .dithering import DitheringCompressor
from .decorators import ErrorFeedback, NesterovMomentum, set_lr_scale
from .registry import create, register, known_compressors
from .reduce import (compressed_tree_all_reduce, init_compression_state,
                     compression_ratio, server_side)

__all__ = [
    "InterCompressor", "Payload", "State",
    "xorshift32", "rng_uniform", "seed_state",
    "OnebitCompressor", "TopkCompressor", "RandomkCompressor",
    "DitheringCompressor", "ErrorFeedback", "NesterovMomentum",
    "set_lr_scale", "server_side",
    "create", "register", "known_compressors",
    "compressed_tree_all_reduce", "init_compression_state",
    "compression_ratio",
]
