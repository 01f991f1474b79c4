"""Worker-side codecs for compressed PS payloads.

Counterpart of ``byteps_tpu/server/wire.py`` (a copy: the port imports
nothing of the JAX package).  The wire is a host byte format, so it stays
numpy at its boundary; moving a CUDA tensor to the host is the caller's
job.

numpy implementations of the PS-tier wire formats, bit-identical to the
C++ server codec (core/server.cc `namespace codec`), so a compressed
push_pull through the server tier reproduces the server's
decompress-sum-recompress exactly (reference: server/server.cc:86-207,
fed by kwargs from the init push, operations.cc:396-408).

This byte codec is the PS plane's contract and is independent of the
collective plane's on-device formats: the port's compressors pack sign
bits into the uint32 words of ops/compressor/bitpack.py (the
``sign_pack`` kernel), while this wire keeps LSB-first uint8 bytes —
payloads from the two planes are NOT interchangeable.

Wire layout (little-endian):
    u8 comp_id | u32 n_elems | body
    onebit(1):    f32 scale | u8 bits[ceil(n/8)]       (LSB-first, 1 = neg)
    topk(2):      u32 k | i32 idx[k] | f32 val[k]
    randomk(3):   u32 k | i32 idx[k] | f32 val[k]
    dithering(4): u8 flags(bit0=natural, bit1=elias) | u8 s | f32 norm | ...
      dense (bit1=0): level bitstream [ceil(n*b/8)] | u8 signs[ceil(n/8)]
                  where b = ceil(log2(s+1)); levels are packed LSB-first at
                  b bits each, byte-contiguous.  (The on-device plane
                  also bit-packs levels, but into uint32 words at 32//b
                  levels per word — bitpack.pack_levels — so the two
                  planes' level streams are NOT interchangeable, like the
                  sign streams.)  s=15 ships 4+1 bits/elem,
                  within the reference's Elias-delta budget (reference:
                  compressor/impl/dithering.cc:51-120) without
                  variable-length decode.
      elias (bit1=1, kwargs coding=elias): u32 nbits | stream — per
                  NONZERO level in index order, EliasDelta(index gap,
                  prev=-1) · sign bit · EliasDelta(level) — the
                  reference's sparse entropy coding.  Bits are LSB-first
                  within bytes; within one code, MSB-of-code-first.
                  Denser than the dense form whenever most levels
                  quantize to 0 (typical gradients).
    qblock(5):    u8 bits(4|8) | u16 block | f32 scale[nblocks] | ints
                  — EQuARX-flavored blockwise integer quantization
                  (arXiv 2506.17615): per `block` elements one f32
                  scale = absmax/qmax (qmax = 2^(bits-1)-1), each
                  element round-half-even(x/scale) clipped to
                  [-qmax, qmax]; bits=4 packs two two's-complement
                  nibbles per byte, low nibble first.  Dense layout,
                  flat decode, deterministic (no PRNG) — the aggressive
                  end of the adaptive-compression dial, EF-capable on
                  both legs under the same law as onebit.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..common.logging import get_logger

COMP_ONEBIT, COMP_TOPK, COMP_RANDOMK, COMP_DITHERING, COMP_QBLOCK = \
    1, 2, 3, 4, 5

_NAMES = {"onebit": COMP_ONEBIT, "topk": COMP_TOPK,
          "randomk": COMP_RANDOMK, "dithering": COMP_DITHERING,
          "qblock": COMP_QBLOCK}

_CWIRE = False   # False = untried, None = unavailable, else the CDLL


def _c_wire():
    """ctypes handle to the C codec in libbyteps_core (the same
    decoder/encoder the server engine runs, ``native.get_native_core()``'s
    library), or None when the native build is unavailable — every caller
    keeps a numpy fallback, so a host without a compiler stays fully
    functional, just slower (the numpy dithering/elias paths are
    10-1000x off the C ones), and a warning says so."""
    global _CWIRE
    if _CWIRE is False:
        try:
            from ..core import native
            lib = native.get_native_core()._lib
        except Exception as e:
            get_logger().warning(
                "native wire codec unavailable (%s); using the numpy codec",
                e)
            _CWIRE = None
        else:
            u64, u32 = ctypes.c_uint64, ctypes.c_uint32
            lib.bps_wire_decode.argtypes = [
                ctypes.c_char_p, u64, ctypes.c_void_p, u64]
            lib.bps_wire_decode.restype = ctypes.c_int
            lib.bps_wire_encode_dithering.argtypes = [
                ctypes.c_void_p, u64, u32, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, u64]
            lib.bps_wire_encode_dithering.restype = ctypes.c_int64
            lib.bps_wire_onebit_correct.argtypes = [
                ctypes.c_void_p, u64, ctypes.c_void_p, ctypes.c_float,
                ctypes.c_void_p]
            lib.bps_wire_onebit_correct.restype = None
            lib.bps_wire_onebit_pack.argtypes = [
                ctypes.c_void_p, u64, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.bps_wire_onebit_pack.restype = None
            lib.bps_wire_encode_qblock.argtypes = [
                ctypes.c_void_p, u64, ctypes.c_int, u32,
                ctypes.c_void_p, ctypes.c_void_p, u64]
            lib.bps_wire_encode_qblock.restype = ctypes.c_int64
            _CWIRE = lib
    return _CWIRE


def native_codec() -> bool:
    """Whether the C codec runs (loading it at the first call)."""
    return _c_wire() is not None


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """bits [n] in {0,1} -> uint8 [ceil(n/8)], LSB-first (matches the C++
    server codec)."""
    return np.packbits(bits.astype(np.uint8), bitorder="little")


def _unpack_bits(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(packed, bitorder="little")[:n]


def _level_bits(s: int) -> int:
    """Bits per level on the wire: ceil(log2(s+1)) for values 0..s."""
    return max(1, int(s).bit_length())


def _pack_levels(level: np.ndarray, s: int) -> np.ndarray:
    """uint8 levels [n] (each <= s) -> LSB-first bitstream at b bits each."""
    b = _level_bits(s)
    bits = ((level[:, None].astype(np.uint8)
             >> np.arange(b, dtype=np.uint8)) & 1)
    return np.packbits(bits.ravel(), bitorder="little")


def _unpack_levels(packed: np.ndarray, n: int, s: int) -> np.ndarray:
    b = _level_bits(s)
    raw = np.unpackbits(packed, bitorder="little",
                        count=n * b).reshape(n, b).astype(np.int32)
    return (raw << np.arange(b, dtype=np.int32)).sum(axis=1)


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Vectorized bit_length for int64 1 <= v < 2^62 (the correction
    shifts clip at 62; wire values — u32 index gaps, u8 levels — are far
    inside the domain)."""
    L = np.floor(np.log2(v.astype(np.float64))).astype(np.int64) + 1
    # float edges: force 2^(L-1) <= v < 2^L exactly
    L = np.where(v >> L.clip(0, 62) > 0, L + 1, L)
    L = np.where((v < (np.int64(1) << (L - 1).clip(0, 62))) & (L > 1),
                 L - 1, L)
    return L


def _elias_delta_codes(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Elias-delta (code, length) pairs for int64 v >= 1.

    Code layout (emitted MSB-of-code-first): LL-1 zeros, then L in LL bits
    (MSB first), then v's low L-1 bits (MSB first) — where L = bitlen(v),
    LL = bitlen(L).  The leading zeros carry no value, so the numeric code
    is L's bits followed by v's low bits; `length` includes the zeros.
    """
    L = _bit_length(v)
    LL = _bit_length(L)
    length = 2 * LL + L - 2
    low_mask = (np.int64(1) << (L - 1)) - 1
    code = (L.astype(np.uint64) << (L - 1).astype(np.uint64)) \
        | (v & low_mask).astype(np.uint64)
    return code, length


def _emit_bitstream(codes: np.ndarray, lengths: np.ndarray) -> Tuple[
        np.ndarray, int]:
    """Concatenate (code, length) pairs into an LSB-first-per-byte
    bitstream; returns (uint8 bytes, total_bits).  Bit i of the stream is
    (byte[i>>3] >> (i&7)) & 1; within one code, bits appear in
    MSB-of-code-first order."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.uint8), 0
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    owner = np.repeat(np.arange(len(codes)), lengths)
    k = np.arange(total) - starts[owner]          # position within code
    shift = (lengths[owner] - 1 - k).astype(np.uint64)
    bits = ((codes[owner] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits, bitorder="little"), total


class _BitCursor:
    """Sequential LSB-first-per-byte bit reader (decode reference path —
    the C++ server codec is the production decoder)."""

    def __init__(self, data: np.ndarray, nbits: int):
        self.bits = np.unpackbits(data, bitorder="little", count=nbits)
        self.pos = 0

    def left(self) -> int:
        return len(self.bits) - self.pos

    def take(self) -> int:
        if self.pos >= len(self.bits):
            raise ValueError("truncated elias stream")
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def take_int(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.take()
        return v

    def elias_delta(self) -> int:
        ll = 1
        while self.left() and self.take() == 0:
            ll += 1
        if ll == 1:
            return 1        # L = 1 -> v = 1
        L = (1 << (ll - 1)) | self.take_int(ll - 1)
        return (1 << (L - 1)) | self.take_int(L - 1)


def _xorshift32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x << np.uint32(13))
    x = x ^ (x >> np.uint32(17))
    x = x ^ (x << np.uint32(5))
    return x


def _seed_state(seed: int, n: int) -> np.ndarray:
    """Mirror of ops/compressor/base.seed_state (numpy)."""
    lanes = np.arange(1, n + 1, dtype=np.uint32)
    with np.errstate(over="ignore"):
        s = lanes * np.uint32(2654435761) + np.uint32(seed | 1)
    s = np.where(s == 0, np.uint32(0x9E3779B9), s)
    return _xorshift32(s)


class WireCompressor:
    """Per-tensor compressed-wire codec with per-partition PRNG state.

    Built from the same string kwargs as the registry
    (ops/compressor/registry.py), which are also shipped verbatim to the
    server at INIT.
    """

    def __init__(self, kwargs: Dict[str, str]):
        from ..ops.compressor.registry import (  # shared parse
            _get, _get_bool, parse_ef, parse_momentum)
        ctype = (kwargs.get("compressor") or kwargs.get("compressor_type")
                 or kwargs.get("byteps_compressor_type"))
        if ctype not in _NAMES:
            raise ValueError(
                f"unsupported PS-wire compressor {ctype!r}; "
                f"known: {sorted(_NAMES)}")
        self.name = ctype
        self.comp_id = _NAMES[ctype]
        self.kwargs = dict(kwargs)
        self.scaled = _get_bool(kwargs, "onebit_scaling", True)
        self.k = int(_get(kwargs, "k", 0))
        self.seed = int(_get(kwargs, "seed", 2020))
        self.s = int(_get(kwargs, "k", 127)) if ctype == "dithering" else 0
        self.partition = str(_get(kwargs, "partition", "linear"))
        self.normalize = str(_get(kwargs, "normalize", "max"))
        # Dithering wire coding: "dense" = fixed ceil(log2(s+1)) bits per
        # level; "elias" = the reference's sparse entropy coding — per
        # NONZERO level, EliasDelta(index gap) · sign bit ·
        # EliasDelta(level) (reference: compressor/impl/dithering.cc:
        # 51-120).  Elias wins when most levels quantize to 0 (real
        # gradients); dense wins on incompressible level streams and
        # keeps decode a flat loop.
        self.coding = str(_get(kwargs, "coding", "dense"))
        if self.coding not in ("dense", "elias"):
            raise ValueError(f"dithering coding={self.coding!r}; "
                             f"options: dense, elias")
        if ctype in ("topk", "randomk") and self.k <= 0:
            raise ValueError(f"{ctype} requires k > 0")
        # Quantized-block params (EQuARX-flavored dense int format).
        self.qb_bits = int(_get(kwargs, "bits", 8)) if ctype == "qblock" \
            else 0
        self.qb_block = min(0xFFFF, max(1, int(_get(kwargs, "block", 256)))
                            ) if ctype == "qblock" else 0
        if ctype == "qblock" and self.qb_bits not in (4, 8):
            raise ValueError(f"qblock bits={self.qb_bits}; options: 4, 8")
        self.bidirectional = ctype in ("onebit", "qblock")
        # Worker-side vanilla error feedback (reference:
        # error_feedback.cc:22-34: grad += e; c = Compress(grad);
        # e = grad - Decompress(c)), per partition key.  The server never
        # applies EF to PUSHES — it only sees corrected payloads (it does
        # run EF on its own recompress leg, core/server.cc ALL_RECV).
        self.ef = parse_ef(kwargs)
        self._err: Dict[int, np.ndarray] = {}
        # Guards _err/_mom against concurrent encoders (different
        # partition keys push from multiple threads) and set_lr_scale's
        # iteration.
        self._state_lock = threading.Lock()
        # Worker-side Nesterov momentum, applied BEFORE EF + compression
        # (reference layering momentum -> ef -> compressor,
        # compressor_registry.cc:39-56; momentum.cc:20-31: m = mu*m + g;
        # g += mu*m).  Worker-only — the kwargs still ship to the server,
        # which ignores momentum like the reference's server registry.
        # Shared parse with the JAX-plane registry so both planes accept
        # the exact same kwargs strings.
        self.momentum_mu = parse_momentum(kwargs)
        self._mom: Dict[int, np.ndarray] = {}
        self._rng: Dict[int, np.ndarray] = {}  # per-partition-key PRNG lanes
        self._last_recon: Optional[np.ndarray] = None  # see encode()

    def set_lr_scale(self, scale: float) -> None:
        """Rescale the carried EF error once when the learning rate
        changes — the reference's `lr.s` mechanism as an explicit API.
        `scale` = prev_lr / new_lr (reference:
        impl/vanilla_error_feedback.cc applies `pre_lr/cur_lr` then sets
        `pre_lr = cur_lr`; multiplying the stored error once is the same
        one-shot semantics, matching the JAX plane's
        ops.compressor.set_lr_scale)."""
        s = np.float32(scale)
        with self._state_lock:
            for k in self._err:
                self._err[k] = self._err[k] * s

    def ef_residual_norm(self) -> float:
        """l2 norm of the carried error-feedback residual across this
        tensor's partitions (0.0 without EF).  The gradient-health
        monitor samples it: a residual growing without bound means the
        compressor is systematically under-shooting (e.g. a scale stuck
        at an overflow) and the "correction" will eventually dwarf the
        gradient itself."""
        if not self.ef:
            return 0.0
        with self._state_lock:
            total = 0.0
            for e in self._err.values():
                total += float(np.dot(e, e))
        return float(np.sqrt(total))

    def take_ef_state(self) -> Dict[int, np.ndarray]:
        """Detach and return the carried per-partition EF residuals — the
        codec-switch handoff: when source and target codecs share vanilla
        EF semantics (an additive residual in gradient space, true for
        every EF-capable wire codec here) the new compressor adopts them
        via :meth:`adopt_ef_state`; otherwise the session folds each
        residual into the key's next push, so a switch can never silently
        drop accumulated error."""
        with self._state_lock:
            err, self._err = self._err, {}
        return err

    def adopt_ef_state(self, err: Dict[int, np.ndarray]) -> None:
        """Adopt residuals from a predecessor codec (see take_ef_state).
        Adds into any residual this compressor already carries — the
        conservation law, not last-write-wins."""
        if not self.ef or not err:
            return
        with self._state_lock:
            for pk, e in err.items():
                mine = self._err.get(pk)
                if mine is not None and mine.size == e.size:
                    self._err[pk] = mine + e
                else:
                    self._err[pk] = np.asarray(e, np.float32)

    def wire_cap_bytes(self, n: int) -> int:
        """Worst-case wire payload size for an n-element partition.

        The codec pipeline charges scheduling credit at enqueue time,
        BEFORE the encode has produced actual wire bytes — this bound
        keeps the charge at compressed scale (an onebit partition charges
        ~n/8, not 4n, preserving the credit law's in-flight concurrency).
        The bound must not meaningfully under-estimate (the charge is
        returned verbatim by report_finish, so bookkeeping stays
        symmetric regardless, but the credit law meters wire bytes).
        The client clamps the charge to the raw partition size: the
        credit floor guarantees one raw partition always fits, and
        elias's worst case exceeds raw by its ~80-byte framing."""
        if self.comp_id == COMP_ONEBIT:
            return 9 + (n + 7) // 8
        if self.comp_id == COMP_QBLOCK:
            nb = (n + self.qb_block - 1) // self.qb_block
            return 8 + 4 * nb + (n if self.qb_bits == 8 else (n + 1) // 2)
        if self.comp_id in (COMP_TOPK, COMP_RANDOMK):
            return 9 + 8 * min(self.k, n)
        # dithering — the same caps the C encoder is given (elias's
        # worst case is ~raw size; dense is b bits + sign per element).
        if self.coding == "elias":
            return 15 + 4 * n + 64
        return 15 + (n * _level_bits(self.s) + 7) // 8 + (n + 7) // 8

    def kwargs_string(self) -> str:
        """Canonical "k=v,k=v" form sent in the INIT payload."""
        kw = {"compressor": self.name}
        if self.ef:
            kw["ef"] = "vanilla"
        if self.momentum_mu:
            kw["momentum"] = "nesterov"
            kw["momentum_mu"] = repr(self.momentum_mu)
        if self.name == "onebit":
            kw["onebit_scaling"] = "1" if self.scaled else "0"
        if self.name == "qblock":
            kw.update(bits=str(self.qb_bits), block=str(self.qb_block))
        if self.name in ("topk", "randomk"):
            kw["k"] = str(self.k)
        if self.name == "randomk":
            kw["seed"] = str(self.seed)
        if self.name == "dithering":
            kw.update(k=str(self.s), seed=str(self.seed),
                      partition=self.partition, normalize=self.normalize)
            if self.coding != "dense":
                kw["coding"] = self.coding
        return ",".join(f"{k}={v}" for k, v in sorted(kw.items()))

    # -- encode -------------------------------------------------------------
    def encode(self, pkey: int, x: np.ndarray) -> bytes:
        x = np.ascontiguousarray(x, np.float32)
        if not (self.momentum_mu or self.ef):
            return self._encode_raw(pkey, x)
        # One lock across the whole stateful read-correct-write: a
        # set_lr_scale landing between the EF read and the error store
        # would otherwise be silently overwritten by an error computed
        # from the unscaled value.  The codec pipeline routinely encodes
        # DIFFERENT partitions of one tensor concurrently on this object:
        # the stateful paths serialize here (state correctness over
        # encode parallelism), while the stateless _encode_raw path runs
        # unlocked and must touch only per-pkey dict entries (GIL-atomic)
        # — no cross-key shared scratch outside this lock.  Same-key
        # rounds stay ordered: the session submits round r+1's encode
        # only after round r's partition fully completed.
        with self._state_lock:
            if self.comp_id == COMP_ONEBIT and x.size:
                lib = _c_wire()
                if lib is not None:
                    # Fused C path: momentum+EF correction in one pass,
                    # sign-pack + error store in another — same float
                    # ops per element as the numpy chain below, so both
                    # paths stay byte- and EF-state-identical (asserted
                    # by the codec parity test).
                    return self._encode_onebit_fused(lib, pkey, x)
            if self.momentum_mu:
                # m = mu*m + g; g += mu*m (Nesterov) — before EF, matching
                # the reference layering and the JAX NesterovMomentum.
                m = self._mom.get(pkey)
                m = (self.momentum_mu * m + x) if m is not None \
                    and m.size == x.size else x.copy()
                self._mom[pkey] = m
                x = x + self.momentum_mu * m
            if not self.ef:
                return self._encode_raw(pkey, x)
            e = self._err.get(pkey)
            if e is not None and e.size == x.size:
                x = x + e
            blob = self._encode_raw(pkey, x)
            # The dithering encoder hands back its reconstruction directly
            # (the elias decode loop is sequential — don't pay it per
            # push); other formats decode the blob, which doubles as a
            # the-error-matches-the-wire self check.
            recon = self._last_recon
            self._last_recon = None
            if recon is None:
                recon = decode(blob, x.size)
            self._err[pkey] = x - recon
            return blob

    def _encode_onebit_fused(self, lib, pkey: int, x: np.ndarray) -> bytes:
        """C-fused onebit encode with momentum/EF state (caller holds
        _state_lock).  The scale reduction stays numpy: its pairwise
        float32 sum is the byte-parity reference for both paths."""
        n = x.size
        xw = np.array(x, np.float32, copy=True)  # never mutate caller's
        mom = None
        if self.momentum_mu:
            mom = self._mom.get(pkey)
            if mom is None or mom.size != n:
                # First push (or size change): m = mu*0 + x == x, the
                # same value the numpy path's m = x.copy() produces.
                mom = np.zeros(n, np.float32)
            self._mom[pkey] = mom
        err = self._err.get(pkey) if self.ef else None
        if err is not None and err.size != n:
            err = None
        lib.bps_wire_onebit_correct(
            xw.ctypes.data, n,
            mom.ctypes.data if mom is not None else None,
            float(self.momentum_mu or 0.0),
            err.ctypes.data if err is not None else None)
        scale = (np.abs(xw).sum() / max(n, 1)) if self.scaled else 1.0
        bits = np.zeros((n + 7) // 8, np.uint8)
        if self.ef:
            new_err = np.empty(n, np.float32)
            lib.bps_wire_onebit_pack(xw.ctypes.data, n, np.float32(scale),
                                     bits.ctypes.data, new_err.ctypes.data)
            self._err[pkey] = new_err
        else:
            lib.bps_wire_onebit_pack(xw.ctypes.data, n, np.float32(scale),
                                     bits.ctypes.data, None)
        return (struct.pack("<BI", self.comp_id, n)
                + struct.pack("<f", np.float32(scale)) + bits.tobytes())

    def _encode_raw(self, pkey: int, x: np.ndarray) -> bytes:
        n = x.size
        self._last_recon = None
        hdr = struct.pack("<BI", self.comp_id, n)
        if self.comp_id == COMP_ONEBIT:
            scale = (np.abs(x).sum() / max(n, 1)) if self.scaled else 1.0
            signs = x < 0
            bits = _pack_bits(signs)
            if self.ef:
                # Reconstruction directly from the signs — the decoded
                # onebit value is just +-scale, so the EF path never
                # needs to re-decode the blob it just wrote.
                self._last_recon = np.where(
                    signs, np.float32(-scale),
                    np.float32(scale)).astype(np.float32)
            return hdr + struct.pack("<f", np.float32(scale)) + bits.tobytes()
        if self.comp_id == COMP_TOPK:
            k = min(self.k, n)
            idx = np.argpartition(np.abs(x), -k)[-k:].astype(np.int32)
            return (hdr + struct.pack("<I", k) + idx.tobytes()
                    + x[idx].tobytes())
        if self.comp_id == COMP_QBLOCK:
            return self._encode_qblock(hdr, x, n)
        if self.comp_id == COMP_RANDOMK:
            k = min(self.k, n)
            rng = self._rng.get(pkey)
            if rng is None:
                rng = _seed_state(self.seed, self.k)
            rng = _xorshift32(rng)
            self._rng[pkey] = rng
            u = (rng >> np.uint32(8)).astype(np.float32) / np.float32(1 << 24)
            idx = np.minimum((u[:k] * n).astype(np.int32), n - 1)
            return (hdr + struct.pack("<I", k) + idx.tobytes()
                    + x[idx].tobytes())
        # dithering
        s = self.s
        if self.normalize == "max":
            norm = float(np.max(np.abs(x))) if n else 0.0
        else:
            norm = float(np.sqrt(np.sum(x * x)))
        norm = max(norm, float(np.finfo(np.float32).tiny))
        lib = _c_wire()
        if lib is not None and n:
            # C fast path: same float32 quantization arithmetic and PRNG
            # as the numpy code below, asserted byte-identical by
            # tests/test_ps_compression.py.  norm stays Python-computed
            # (numpy's pairwise float32 sum is the l2 parity reference).
            rng = self._rng.get(pkey)
            if rng is None or rng.size < n:
                rng = _seed_state(self.seed, n)
            # The C encoder advances the lanes IN PLACE — hand it a private
            # copy and store that back only on success, so a failed encode
            # (wrote <= 0, cap exhausted) leaves the per-key state
            # untouched and the numpy fallback below continues from
            # unadvanced lanes (byte/PRNG parity with a pure-numpy worker).
            rng = np.array(rng[:n], dtype=np.uint32)
            recon = np.empty(n, np.float32) if self.ef else None
            elias = self.coding == "elias"
            cap = 15 + (4 * n + 64 if elias
                        else (n * _level_bits(s) + 7) // 8 + (n + 7) // 8)
            out = np.empty(cap, np.uint8)
            wrote = lib.bps_wire_encode_dithering(
                x.ctypes.data, n, s,
                1 if self.partition == "natural" else 0,
                1 if elias else 0, float(np.float32(norm)),
                rng.ctypes.data,
                recon.ctypes.data if recon is not None else None,
                out.ctypes.data, cap)
            if wrote > 0:
                self._rng[pkey] = rng
                if recon is not None:
                    self._last_recon = recon
                return out[:wrote].tobytes()
        mag = np.abs(x) / np.float32(norm)
        levels = self._levels()
        j = np.clip(np.searchsorted(levels, mag, side="right") - 1, 0, s - 1)
        lo, hi = levels[j], levels[j + 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            p_up = np.where(hi > lo, (mag - lo) / np.maximum(hi - lo, 1e-30),
                            0.0)
        rng = self._rng.get(pkey)
        if rng is None:
            rng = _seed_state(self.seed, n)
        rng = _xorshift32(rng[:n])
        self._rng[pkey] = rng
        u = (rng >> np.uint32(8)).astype(np.float32) / np.float32(1 << 24)
        level = (j + (u < p_up)).astype(np.uint8)
        signs = x < 0
        if self.ef:
            # EF reconstruction computed here so encode() never needs the
            # (sequential) elias decode loop; skipped entirely without EF
            # (no extra O(n) pass or retained buffer).
            if self.partition == "natural":
                mag = np.where(level == 0, 0.0,
                               2.0 ** (level.astype(np.float32) - s))
            else:
                mag = level.astype(np.float32) / np.float32(s)
            self._last_recon = ((1.0 - 2.0 * signs) * mag
                                * np.float32(norm)).astype(np.float32)
        flags = 1 if self.partition == "natural" else 0
        if self.coding == "elias":
            flags |= 2
            nz = np.flatnonzero(level)
            if nz.size:
                gaps = np.diff(nz, prepend=-1).astype(np.int64)
                gcode, glen = _elias_delta_codes(gaps)
                lcode, llen = _elias_delta_codes(level[nz].astype(np.int64))
                scode = signs[nz].astype(np.uint64)
                slen = np.ones(nz.size, np.int64)
                codes = np.stack([gcode, scode, lcode], 1).ravel()
                lens = np.stack([glen, slen, llen], 1).ravel()
                stream, nbits = _emit_bitstream(codes, lens)
            else:
                stream, nbits = np.zeros(0, np.uint8), 0
            return (hdr + struct.pack("<BBfI", flags, s, np.float32(norm),
                                      nbits) + stream.tobytes())
        return (hdr + struct.pack("<BBf", flags, s, np.float32(norm))
                + _pack_levels(level, s).tobytes()
                + _pack_bits(signs).tobytes())

    def _encode_qblock(self, hdr: bytes, x: np.ndarray, n: int) -> bytes:
        """Blockwise int4/int8 quantization (COMP_QBLOCK).  The C path is
        byte-identical to the numpy fallback below: both compute the
        per-block scale as f32 absmax/qmax, quantize by TRUE f32 division
        then round-half-to-even (np.rint / rintf), and reconstruct as
        q * scale — asserted by tests/test_tuner.py."""
        bits, block = self.qb_bits, self.qb_block
        qmax = (1 << (bits - 1)) - 1
        nb = (n + block - 1) // block
        lib = _c_wire()
        if lib is not None and n:
            cap = 8 + 4 * nb + (n if bits == 8 else (n + 1) // 2)
            out = np.empty(cap, np.uint8)
            recon = np.empty(n, np.float32) if self.ef else None
            wrote = lib.bps_wire_encode_qblock(
                x.ctypes.data, n, bits, block,
                recon.ctypes.data if recon is not None else None,
                out.ctypes.data, cap)
            if wrote > 0:
                if recon is not None:
                    self._last_recon = recon
                return out[:wrote].tobytes()
        xp = np.zeros(nb * block, np.float32)
        xp[:n] = x
        xb = xp.reshape(nb, block)
        amax = np.abs(xb).max(axis=1) if n else np.zeros(nb, np.float32)
        scale = (amax / np.float32(qmax)).astype(np.float32)
        safe = np.where(scale > 0, scale, np.float32(1)).astype(np.float32)
        q = np.clip(np.rint(xb / safe[:, None]), -qmax, qmax)
        q = np.where(scale[:, None] > 0, q, 0).astype(np.int8)
        if self.ef:
            self._last_recon = (q.astype(np.float32)
                                * scale[:, None]).ravel()[:n].astype(
                                    np.float32)
        qflat = q.ravel()[:n]
        if bits == 8:
            body = qflat.tobytes()
        else:
            u = (qflat.astype(np.int16) & 0xF).astype(np.uint8)
            if n % 2:
                u = np.append(u, np.uint8(0))
            body = (u[0::2] | (u[1::2] << 4)).astype(np.uint8).tobytes()
        return (hdr + struct.pack("<BH", bits, block)
                + scale.tobytes() + body)

    def _levels(self) -> np.ndarray:
        s = self.s
        if self.partition == "linear":
            return np.arange(s + 1, dtype=np.float32) / np.float32(s)
        pts = 2.0 ** np.arange(-(s - 1), 1, dtype=np.float32)
        return np.concatenate([np.zeros(1, np.float32), pts])


def decode(data, n: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode any compressed wire payload to an n-element f32 vector
    (the worker pull-leg decompress for bidirectional compressors).

    ``data`` may be bytes OR any buffer-protocol object (bytearray /
    memoryview) — the receive path hands pooled buffer views straight in,
    with no bytes() snapshot.  ``out``, when given, is a contiguous
    n-element float32 array the decode lands in directly (the handle's
    output sink on the pull path); it is also returned.

    Rides the C decoder from libbyteps_core.so when available (the
    exact routine the server engine runs — the numpy paths below are
    the behavioral reference and the toolchain-less fallback; the
    elias path in particular is ~1000x slower in Python)."""
    comp, wn = struct.unpack_from("<BI", data, 0)
    if wn != n:
        raise ValueError(f"wire n={wn} != expected {n}")
    if out is not None and (out.size != n or out.dtype != np.float32
                            or not out.flags.c_contiguous):
        raise ValueError("decode out= must be a contiguous f32[n] array")
    lib = _c_wire()
    if lib is not None:
        dst = out if out is not None else np.empty(n, np.float32)
        if lib.bps_wire_decode(_c_buf(data), len(data),
                               dst.ctypes.data, n) == 0:
            return dst
        raise ValueError("malformed compressed wire payload (C decoder)")
    res = _decode_py(data, n)
    if out is not None:
        out[:] = res
        return out
    return res


def _c_buf(data):
    """`data` as a ctypes-compatible char buffer WITHOUT copying: bytes
    pass through (c_char_p converts natively); writable buffers
    (bytearray, pooled memoryviews) wrap via from_buffer; anything
    read-only falls back to one snapshot."""
    if isinstance(data, bytes):
        return data
    try:
        return (ctypes.c_char * len(data)).from_buffer(data)
    except (TypeError, BufferError):
        return bytes(data)


def _decode_py(data: bytes, n: int) -> np.ndarray:
    """numpy reference decoder (kept as the toolchain-less fallback and
    the cross-implementation parity target for tests)."""
    comp, wn = struct.unpack_from("<BI", data, 0)
    if wn != n:
        raise ValueError(f"wire n={wn} != expected {n}")
    body = memoryview(data)[5:]
    if comp == COMP_ONEBIT:
        (scale,) = struct.unpack_from("<f", body, 0)
        bits = _unpack_bits(
            np.frombuffer(body[4:4 + (n + 7) // 8], np.uint8), n)
        return np.where(bits.astype(bool), -scale, scale).astype(np.float32)
    if comp in (COMP_TOPK, COMP_RANDOMK):
        (k,) = struct.unpack_from("<I", body, 0)
        idx = np.frombuffer(body[4:4 + 4 * k], np.int32)
        val = np.frombuffer(body[4 + 4 * k:4 + 8 * k], np.float32)
        out = np.zeros(n, np.float32)
        np.add.at(out, idx, val)
        return out
    if comp == COMP_QBLOCK:
        bits, block = struct.unpack_from("<BH", body, 0)
        if bits not in (4, 8) or block == 0:
            raise ValueError(f"qblock bits={bits} block={block}")
        nb = (n + block - 1) // block
        scales = np.frombuffer(body[3:3 + 4 * nb], np.float32)
        qb = body[3 + 4 * nb:]
        if bits == 8:
            q = np.frombuffer(qb[:n], np.int8).astype(np.float32)
        else:
            u = np.frombuffer(qb[:(n + 1) // 2], np.uint8)
            nib = np.empty(2 * u.size, np.uint8)
            nib[0::2] = u & 0xF
            nib[1::2] = u >> 4
            q = (((nib[:n].astype(np.int16)) ^ 8) - 8).astype(np.float32)
        qp = np.zeros(nb * block, np.float32)
        qp[:n] = q
        return (qp.reshape(nb, block)
                * scales[:, None]).ravel()[:n].astype(np.float32)
    if comp == COMP_DITHERING:
        flags, s, norm = struct.unpack_from("<BBf", body, 0)
        if flags & 2:
            # Sparse elias coding: EliasDelta(gap) · sign · EliasDelta(lvl)
            # per nonzero.  Sequential reference decoder — the C++ server
            # codec is the production path; encode-side EF uses the direct
            # reconstruction and never calls this.
            (nbits,) = struct.unpack_from("<I", body, 6)
            cur = _BitCursor(np.frombuffer(
                body[10:10 + (nbits + 7) // 8], np.uint8), nbits)
            level = np.zeros(n, np.int64)
            signs = np.zeros(n, np.uint8)
            pos = -1
            while cur.left() > 0:
                pos += cur.elias_delta()
                if pos >= n:
                    raise ValueError("elias stream overruns tensor")
                sgn = cur.take()
                lvl = cur.elias_delta()
                if lvl > s:
                    raise ValueError(f"elias level {lvl} > s={s}")
                level[pos] = lvl
                signs[pos] = sgn
        else:
            lvlbytes = (n * _level_bits(s) + 7) // 8
            level = _unpack_levels(
                np.frombuffer(body[6:6 + lvlbytes], np.uint8), n, s)
            signs = _unpack_bits(
                np.frombuffer(body[6 + lvlbytes:6 + lvlbytes + (n + 7) // 8],
                              np.uint8), n)
        if flags & 1:
            mag = np.where(level == 0, 0.0,
                           2.0 ** (level.astype(np.float32) - s))
        else:
            mag = level.astype(np.float32) / np.float32(s)
        sign = 1.0 - 2.0 * signs.astype(np.float32)
        return (sign * mag * norm).astype(np.float32)
    raise ValueError(f"unknown comp_id {comp}")


# ---------------------------------------------------------------------------
# Row-sparse embedding wire format (WireDtype kSparseRows / kSparseRead).
#
# Block header, little-endian, 16 bytes (C++ SparseHdr):
#     u32 nrows | u32 width | u8 codec | u8 pad | u16 pad | u32 idx_bytes
# codec 0 = raw u32 LE indices; codec 1 = elias-delta over the gaps of
# the SORTED UNIQUE index list (first code = idx[0]+1, then
# idx[i]-idx[i-1]; every code >= 1), bit-matched to the dithering
# codec's elias stream (LSB-first within bytes, MSB-of-code-first).
#
# Push payload   = header | index stream | nrows*width f32 rows (in
#                  index order).
# Pull request   = header | index stream (width pinned so the server can
#                  cross-check the declared table).
# Pull response  = u64 param_version | nrows*width f32 rows in REQUEST
#                  order.
# ---------------------------------------------------------------------------

SPARSE_HDR = struct.Struct("<IIBBHI")
SPARSE_CODEC_RAW = 0
SPARSE_CODEC_ELIAS = 1


def encode_sparse_indices(idx: np.ndarray) -> Tuple[int, bytes]:
    """Encode a SORTED UNIQUE u32 index vector -> (codec, bytes).

    Picks elias-delta when it is strictly smaller than raw u32 — a
    deterministic rule, so identical index sets always produce identical
    wire bytes (the byte-identity tests depend on it)."""
    idx = np.ascontiguousarray(idx, dtype=np.uint32)
    if idx.size == 0:
        return SPARSE_CODEC_RAW, b""
    gaps = np.empty(idx.size, np.int64)
    gaps[0] = int(idx[0]) + 1
    gaps[1:] = np.diff(idx.astype(np.int64))
    if np.any(gaps[1:] <= 0):
        raise ValueError("sparse indices must be sorted and unique")
    codes, lengths = _elias_delta_codes(gaps)
    stream, _ = _emit_bitstream(codes, lengths)
    if stream.nbytes < idx.nbytes:
        return SPARSE_CODEC_ELIAS, stream.tobytes()
    return SPARSE_CODEC_RAW, idx.tobytes()


def decode_sparse_indices(codec: int, data: bytes, nrows: int) -> np.ndarray:
    """Inverse of encode_sparse_indices (reference decoder; the C++
    server's DecodeSparseIndices is the production path)."""
    if codec == SPARSE_CODEC_RAW:
        if len(data) < 4 * nrows:
            raise ValueError("truncated raw index stream")
        return np.frombuffer(data[:4 * nrows], np.uint32).copy()
    if codec != SPARSE_CODEC_ELIAS:
        raise ValueError(f"unknown sparse index codec {codec}")
    cur = _BitCursor(np.frombuffer(data, np.uint8), len(data) * 8)
    out = np.empty(nrows, np.uint32)
    pos = -1
    for i in range(nrows):
        pos += cur.elias_delta()
        out[i] = pos
    return out


def encode_sparse_block(idx: np.ndarray, rows: Optional[np.ndarray],
                        width: int) -> bytes:
    """Header + index stream (+ f32 rows when `rows` is given — the push
    form; None gives the pull-request form)."""
    idx = np.ascontiguousarray(idx, dtype=np.uint32)
    codec, istream = encode_sparse_indices(idx)
    hdr = SPARSE_HDR.pack(idx.size, width, codec, 0, 0, len(istream))
    if rows is None:
        return hdr + istream
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if rows.size != idx.size * width:
        raise ValueError(
            f"rows {rows.size} != nrows {idx.size} * width {width}")
    return hdr + istream + rows.tobytes()


def decode_sparse_block(payload) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Inverse of encode_sparse_block: -> (indices, rows-or-None)."""
    buf = bytes(payload)
    nrows, width, codec, _, _, ibytes = SPARSE_HDR.unpack_from(buf, 0)
    idx = decode_sparse_indices(codec, buf[16:16 + ibytes], nrows)
    body = buf[16 + ibytes:]
    if not body:
        return idx, None
    want = nrows * width * 4
    if len(body) < want:
        raise ValueError("truncated sparse row payload")
    rows = np.frombuffer(body[:want], np.float32).reshape(nrows, width)
    return idx, rows.copy()


def decode_sparse_response(payload, nrows: int,
                           width: int) -> Tuple[int, np.ndarray]:
    """Pull/read response -> (param_version, rows [nrows, width] f32)."""
    buf = memoryview(payload)
    if len(buf) < 8 + nrows * width * 4:
        raise ValueError(
            f"sparse response {len(buf)}B < {8 + nrows * width * 4}B "
            f"({nrows} rows x {width})")
    (version,) = struct.unpack_from("<Q", buf, 0)
    rows = np.frombuffer(buf[8:8 + nrows * width * 4],
                         np.float32).reshape(nrows, width).copy()
    return version, rows
