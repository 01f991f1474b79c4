"""Sign-bit packing as hand-written Hopper kernels, and b-bit level packing.

Counterpart of ``byteps_tpu/ops/compressor/bitpack.py``, with its wire
format bit for bit: an n-element input packs into ``words_len(n)`` 32-bit
words, where element i of the zero-padded input sets bit ``(i//128) % 32``
of word ``(i//4096)*128 + i%128`` iff it is negative (``x < 0``: -0.0 and
NaN give 0).  A (32, 128) tile of 4096 elements makes 128 words, and tile
counts above 32 round up to a multiple of 8.

The words travel as ``torch.int32`` tensors holding the same bits as the
JAX package's uint32 array (``.numpy().view(numpy.uint32)`` gives it back):
torch's uint32 supports few operations, and neither gloo nor NCCL reliably
carries it.  Bit arithmetic in the plain versions runs in int64.

The kernels live in ``csrc/bitpack.cu`` (see its header for the design and
what bounds them on the H100):

  - ``sign_pack``    float32 [n] -> words [words_len(n)]
  - ``sign_unpack``  words [..., words_len(n)] -> +-1.0 float32 [..., n];
    any number of rows (the gathered payloads of a world) in one launch.

Each wrapper runs its kernel for CUDA tensors and the plain PyTorch version
beside it (``*_plain``) for CPU tensors; for a CUDA tensor it launches the
kernel or raises.  ``launches`` counts kernel launches per wrapper.

The level packing of the dithering compressor (``pack_levels`` /
``unpack_levels``) is lowered by XLA in the JAX package, not written in
Pallas, and is plain PyTorch here.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build

SOURCE = "bitpack.cu"
LANES = 128
SUBLANES = 32
GRAN = LANES * SUBLANES          # 4096 elements per (32, 128) tile
_MAX_BS = 32                     # the JAX kernel's tiles per grid block
_MASK32 = 0xFFFFFFFF

# Kernel launches since the last reset_launches(), per wrapper.
launches: Dict[str, int] = {"sign_pack": 0, "sign_unpack": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _num_tiles(n: int) -> int:
    t = -(-n // GRAN)
    if t > _MAX_BS and t % 8:
        t += 8 - t % 8  # the JAX kernel's block tiling; part of the format
    return t


def _padded_len(n: int) -> int:
    return _num_tiles(n) * GRAN


def words_len(n: int) -> int:
    """Length of the packed word array for an n-element input: inputs
    below 4096 elements pay a 512-byte floor, and tile counts above 32
    round up to a multiple of 8 (<= 21% overhead, worst at 33 tiles)."""
    return _padded_len(n) // SUBLANES


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor holding the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _as_uint(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned 32-bit values, in int64."""
    return words.to(torch.int64) & _MASK32


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same functions over the padded (S, 32, 128)
# view, as the JAX package's jnp path computes them.
# ---------------------------------------------------------------------------
def pack_signs_plain(x: torch.Tensor) -> torch.Tensor:
    n = x.numel()
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=x.device)
    xf = x.reshape(-1).float()
    pad = _padded_len(n) - n
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])
    bits = (xf.view(-1, SUBLANES, LANES) < 0).to(torch.int64)
    row = torch.arange(SUBLANES, dtype=torch.int64,
                       device=x.device)[None, :, None]
    return _as_int32((bits << row).sum(1)).reshape(-1)


def unpack_signs_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    lead = tuple(words.shape[:-1])
    if n == 0:
        return torch.zeros(lead + (0,), dtype=torch.float32,
                           device=words.device)
    w = _as_uint(words).reshape(lead + (-1, 1, LANES))
    row = torch.arange(SUBLANES, dtype=torch.int64,
                       device=words.device)[:, None]
    bits = (w >> row) & 1                    # [..., S, 32, 128]
    return (1.0 - 2.0 * bits.to(torch.float32)).reshape(lead + (-1,))[
        ..., :n]


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors.
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_L = ctypes.c_longlong
_SIGNATURES = {
    "bps_sign_pack": [_P, _P, _L, _L, _L, _P],
    "bps_sign_unpack": [_P, _P, _L, _L, _L, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_bps_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bps_bitpack_error_string.argtypes = [ctypes.c_int]
        lib.bps_bitpack_error_string.restype = ctypes.c_char_p
        lib._bps_typed = True
    return lib


def build() -> None:
    """Compile and load the kernels now (they otherwise build at first use)."""
    _lib()


def _launch(name: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, f"bps_{name}")(*args)
    if err:
        msg = lib.bps_bitpack_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
    launches[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """float [n] (any shape, flattened) -> int32 [words_len(n)] of sign
    bits (1 = negative)."""
    if not x.is_cuda:
        return pack_signs_plain(x)
    n = x.numel()
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=x.device)
    xf = x.reshape(-1)
    if xf.dtype != torch.float32:
        xf = xf.float()
    xf = xf.contiguous()
    wl = words_len(n)
    words = torch.empty((wl,), dtype=torch.int32, device=x.device)
    _launch("sign_pack", xf.data_ptr(), words.data_ptr(), 1, n, wl,
            _stream(x))
    return words


def unpack_signs(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [..., words_len(n)] -> float32 [..., n] of +-1 signs."""
    if words.shape[-1:] != (words_len(n),):
        raise ValueError(f"unpack_signs: {tuple(words.shape)} words do not "
                         f"hold n={n} signs (want {words_len(n)} per row)")
    if not words.is_cuda:
        return unpack_signs_plain(words, n)
    if words.dtype != torch.int32:
        raise TypeError(f"unpack_signs: words must be int32, got "
                        f"{words.dtype}")
    lead = tuple(words.shape[:-1])
    out = torch.empty(lead + (n,), dtype=torch.float32, device=words.device)
    rows = out.numel() // n if n else 0
    if rows:
        w = words.contiguous()
        _launch("sign_unpack", w.data_ptr(), out.data_ptr(), rows, n,
                words.shape[-1], _stream(words))
    return out


# ---------------------------------------------------------------------------
# b-bit level packing (dithering levels): the same sublane layout, k = 32//b
# levels per word, as plain PyTorch ops (XLA-lowered in the JAX package).
# ---------------------------------------------------------------------------
def level_bits(s: int) -> int:
    """Wire bits per level for values 0..s."""
    return max(1, int(s).bit_length())


def _levels_per_word(b: int) -> int:
    return SUBLANES // b


def level_words_len(n: int, s: int) -> int:
    k = _levels_per_word(level_bits(s))
    return -(-n // (k * LANES)) * LANES


def pack_levels(level: torch.Tensor, s: int) -> torch.Tensor:
    """Levels [n] (each <= s) -> int32 [level_words_len(n, s)]."""
    b = level_bits(s)
    k = _levels_per_word(b)
    n = level.numel()
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=level.device)
    pad = level_words_len(n, s) * k - n
    lv = level.reshape(-1).to(torch.int64)
    if pad:
        lv = torch.cat([lv, lv.new_zeros(pad)])
    row = (torch.arange(k, dtype=torch.int64, device=level.device)
           * b)[None, :, None]
    # Disjoint bit fields: the sum equals the OR.
    return _as_int32((lv.view(-1, k, LANES) << row).sum(1)).reshape(-1)


def unpack_levels(words: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """int32 [..., level_words_len(n, s)] -> int32 [..., n] levels."""
    b = level_bits(s)
    k = _levels_per_word(b)
    lead = tuple(words.shape[:-1])
    if n == 0:
        return torch.zeros(lead + (0,), dtype=torch.int32,
                           device=words.device)
    w = _as_uint(words).reshape(lead + (-1, 1, LANES))
    row = (torch.arange(k, dtype=torch.int64, device=words.device)
           * b)[:, None]
    lv = (w >> row) & ((1 << b) - 1)
    return lv.reshape(lead + (-1,))[..., :n].to(torch.int32)
