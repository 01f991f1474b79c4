"""Flash attention: hand-written Hopper kernels, forward and backward.

Counterpart of ``byteps_tpu/ops/flash_attention.py``.  Attention is computed
blockwise with an online softmax, so no [S, S] logits tensor is ever stored,
and the backward recomputes the probabilities from the saved log-sum-exp.
The kernels live in ``csrc/flash_attention.cu`` (see its header for the
tiling and what bounds each kernel on the H100), in the JAX package's two
families:

  - K/V-resident:
    ``flash_fwd``      q, k, v -> O (input dtype), LSE [BH, S] float32
    ``flash_bwd_dq``   q, k, v, O, LSE, dO -> dQ, delta = rowsum(dO * O)
    ``flash_bwd_dkv``  q, k, v, dO, LSE, delta -> dK, dV
  - streaming (long S), the same three functions with the contraction axis
    cut into splits (``_split_len``) whose float32 partials are merged in a
    fixed order:
    ``flash_fwd_str``, ``flash_bwd_dq_str``, ``flash_bwd_dkv_str``

``flash_attention`` picks the family by the JAX package's rule
(``_use_streaming``) on the caller's shape, then zero-pads the head dim up
to the next one the kernels take (``kernel_head_dim``: one of
``HEAD_DIMS`` up to ``MAX_HEAD_DIM``, a multiple of ``WIDE_COLS`` above
it, where the wide kernels run the D / 128 column slices of a tile as one
cluster) and slices the output back (``_pad_head_dim``).  Each wrapper
runs its kernel for CUDA tensors and the plain PyTorch version
beside it (``*_plain``) for CPU tensors; for a CUDA tensor it launches the
kernel or raises.  A wrapper cuts B*H into contiguous slices of at most
``MAX_LAUNCH_BH`` rows (the grid's y/z limit), one launch each.
``launches`` counts launches per wrapper (a streaming launch runs its
partial kernel and the merge or sum passes behind it), and
``instance_launches`` the same per instantiation, as
``"flash_fwd<bf16,64>"``.

Layout: q, k, v are [BH, S, D] (batch*heads folded), as in the JAX package.
The JAX version stores LSE as [BH, 1, S] for TPU tiling; here it is [BH, S].
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils import flop_counter
from torch.utils.flop_counter import register_flop_formula

from ..common.device import is_dtensor
from . import _build

# The dispatch mode a FlopCounterMode pushes (itself in older torch).
_COUNTER_MODES = (getattr(flop_counter, "_FlopCounterMode",
                          flop_counter.FlopCounterMode),)

SOURCE = "flash_attention.cu"
TILE = 64                           # the kernels' q and k tile (rows)
HEAD_DIMS = (16, 32, 64, 128, 256)  # head dims the kernels are built for
MAX_HEAD_DIM = HEAD_DIMS[-1]        # above it: the wide kernels
WIDE_COLS = 128                     # the wide kernels' D is a multiple
MAX_LAUNCH_BH = 65535               # B*H rows of one launch (gridDim.y/z)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}

# The JAX package's selection rule, kept for parity: K+V above this many
# bytes take the streaming family (there: ~16 MB of VMEM per TPU core).
# Read at call time, as the JAX package reads its own.
RESIDENT_VMEM_BUDGET = 6 * 1024 * 1024
# Splits of the streaming family: at least SPLIT_MIN_KEYS keys (or queries)
# each, and at most MAX_SPLITS of them (see _split_len).
SPLIT_MIN_KEYS = 4096
MAX_SPLITS = 8

# Kernel launches since the last reset_launches(), per wrapper.
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "flash_fwd_str": 0,
                            "flash_bwd_dq_str": 0, "flash_bwd_dkv_str": 0}
# The same launches per instantiation: "flash_fwd<bf16,64>" -> count.
instance_launches: Dict[str, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    instance_launches.clear()


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "bps_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "bps_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _F, _I, _P],
    "bps_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _I, _P],
    "bps_flash_fwd_str": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _I, _I, _P],
    "bps_flash_bwd_dq_str": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _F, _I, _I, _P],
    "bps_flash_bwd_dkv_str": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _F, _I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_bps_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bps_cuda_error_string.argtypes = [ctypes.c_int]
        lib.bps_cuda_error_string.restype = ctypes.c_char_p
        lib._bps_typed = True
    return lib


def build() -> None:
    """Compile and load the kernels now (they otherwise build at first use)."""
    _lib()


def _check_cuda(name: str, *tensors: torch.Tensor) -> Tuple[int, int, int]:
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError(f"{name}: expected [BH, S, D] tensors, got "
                         f"{tuple(q.shape)}")
    bh, s, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported by the CUDA "
                        f"kernel (float32, bfloat16, float16)")
    if d not in HEAD_DIMS and (d <= MAX_HEAD_DIM or d % WIDE_COLS):
        raise ValueError(f"{name}: head_dim {d} not supported by the CUDA "
                         f"kernel {HEAD_DIMS} or a multiple of {WIDE_COLS} "
                         f"above {MAX_HEAD_DIM}")
    if s % TILE:
        raise ValueError(f"{name}: seq_len {s} must be a multiple of the "
                         f"kernel tile {TILE}")
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: shape/dtype mismatch "
                             f"{tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(q.shape)} {q.dtype}")
    return bh, s, d


def _check_rows(name: str, bh: int, s: int, *rows: torch.Tensor) -> None:
    for t in rows:
        if (t.shape != (bh, s) or t.dtype != torch.float32
                or not t.is_contiguous() or not t.is_cuda):
            raise ValueError(f"{name}: lse/delta must be contiguous float32 "
                             f"[{bh}, {s}] on CUDA, got {tuple(t.shape)} "
                             f"{t.dtype}")


def _bh_slices(bh: int):
    """Contiguous slices of B*H rows, at most MAX_LAUNCH_BH each."""
    return [slice(i, min(i + MAX_LAUNCH_BH, bh))
            for i in range(0, bh, MAX_LAUNCH_BH)]


def _launch(name: str, ins, outs, workspaces, *tail) -> None:
    """bps_<name>(*ins, *outs, *workspaces, bh, s, d, dtype, *tail, stream)
    once per B*H slice: ins and outs are offset to the slice's first row,
    the workspaces (allocated for at most MAX_LAUNCH_BH rows) are reused by
    each launch.  Pointers are offset as integers: a tensor view per slice
    would cost more host time than a short kernel runs."""
    q = ins[0]
    bh, s, d = q.shape
    lib = _lib()
    fn = getattr(lib, f"bps_{name}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rows = [(t.data_ptr(), t.stride(0) * t.element_size())
            for t in (*ins, *outs)]
    ws = [w.data_ptr() for w in workspaces]
    key = f"{name}<{_DTYPE_NAMES[q.dtype]},{d}>"
    for sl in _bh_slices(bh):
        err = fn(*(p + sl.start * row for p, row in rows), *ws,
                 sl.stop - sl.start, s, d, _DTYPE_CODES[q.dtype], *tail,
                 stream)
        if err:
            msg = lib.bps_cuda_error_string(err).decode()
            raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
        launches[name] += 1
        instance_launches[key] = instance_launches.get(key, 0) + 1


def _causal_mask(s: torch.Tensor) -> torch.Tensor:
    n = s.shape[-1]
    keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
    return s.masked_fill(~keep, float("-inf"))


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same functions, whole-sequence, float32 math.
# ---------------------------------------------------------------------------
def flash_fwd_plain(q, k, v, causal: bool, scale: float):
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    if causal:
        s = _causal_mask(s)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return (p @ v.float()).to(q.dtype), lse


def _delta(o, do):
    """rowsum(dO * O), summed in float64 and rounded once to float32: the
    sum cancels, and a float32 sum's own error reaches the 1e-5 relative
    gate at D = 384 (csrc/flash_attention.cu, delta_sum;
    scripts/cpu_precision_checks.py measures it)."""
    return (do.double() * o.double()).sum(-1).float()


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    s = scale * (q.float() @ k.float().transpose(-1, -2))
    if causal:
        s = _causal_mask(s)
    p = torch.exp(s - lse[..., None])
    dp = do.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    delta = _delta(o, do)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    return (scale * (ds @ k.float())).to(q.dtype), delta


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dk = scale * (ds.transpose(-1, -2) @ q.float())
    dv = p.transpose(-1, -2) @ do.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the streaming family: the kernels' split/merge
# arithmetic, split by split, so that only one split's [BH, S, split]
# logits exist at a time.  Under causal masking the rows before a k split
# (or the keys after a q split) see none of it and are left out, as the
# kernels skip their dead (tile, split) pairs.
# ---------------------------------------------------------------------------
def _split_len(s: int) -> int:
    """Keys (forward, dQ) or queries (dK/dV) in one split at sequence
    length s: whole tiles, at least SPLIT_MIN_KEYS, and no more than
    MAX_SPLITS splits.  A CTA then walks at most max(SPLIT_MIN_KEYS,
    S / MAX_SPLITS) keys, and each float32 workspace holds at most
    MAX_SPLITS partials of the output: 8 splits of 4,096 at S = 32,768,
    8 of 16,384 at S = 131,072."""
    per_split = -(-s // MAX_SPLITS)
    return max(SPLIT_MIN_KEYS, -(-per_split // TILE) * TILE)


def _mask_after(s: torch.Tensor, row0: int, col0: int) -> torch.Tensor:
    """Logits [.., R, C] of rows row0.. and keys col0..: key > row -> -inf
    (in place)."""
    rows = torch.arange(row0, row0 + s.shape[-2], device=s.device)
    cols = torch.arange(col0, col0 + s.shape[-1], device=s.device)
    return s.masked_fill_(cols[None, :] > rows[:, None], float("-inf"))


def flash_fwd_str_plain(q, k, v, causal: bool, scale: float):
    bh, s, d = q.shape
    split = _split_len(s)
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    parts = []                        # (first row, m, l, acc) per k split
    for j0 in range(0, s, split):
        r0 = j0 if causal else 0
        kj, vj = kf[:, j0:j0 + split], vf[:, j0:j0 + split]
        logits = qf[:, r0:] @ kj.transpose(-1, -2)
        if causal:
            _mask_after(logits, r0, j0)
        m = logits.amax(-1)
        p = logits.sub_(m[..., None]).exp_()
        parts.append((r0, m, p.sum(-1), p @ vj))
        del logits, p
    mx = torch.full((bh, s), float("-inf"), device=q.device)
    for r0, m, _, _ in parts:
        mx[:, r0:] = torch.maximum(mx[:, r0:], m)
    l = torch.zeros(bh, s, device=q.device)
    acc = torch.zeros(bh, s, d, device=q.device)
    for r0, m, lj, aj in parts:
        w = torch.exp(m - mx[:, r0:])
        l[:, r0:] += w * lj
        acc[:, r0:] += w[..., None] * aj
    return (acc / l[..., None]).to(q.dtype), mx + torch.log(l)


def flash_bwd_dq_str_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    s = q.shape[1]
    split = _split_len(s)
    delta = _delta(o, do)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros_like(qf)
    for j0 in range(0, s, split):
        r0 = j0 if causal else 0
        kj, vj = kf[:, j0:j0 + split], vf[:, j0:j0 + split]
        logits = (qf[:, r0:] @ kj.transpose(-1, -2)).mul_(scale)
        if causal:
            _mask_after(logits, r0, j0)
        p = logits.sub_(lse[:, r0:, None]).exp_()
        ds = (dof[:, r0:] @ vj.transpose(-1, -2)).sub_(delta[:, r0:, None])
        dq[:, r0:] += ds.mul_(p) @ kj
        del logits, p, ds
    return (scale * dq).to(q.dtype), delta


def flash_bwd_dkv_str_plain(q, k, v, do, lse, delta, causal: bool,
                            scale: float):
    s = q.shape[1]
    split = _split_len(s)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0 in range(0, s, split):
        c1 = min(i0 + split, s) if causal else s
        qi, doi = qf[:, i0:i0 + split], dof[:, i0:i0 + split]
        logits = (qi @ kf[:, :c1].transpose(-1, -2)).mul_(scale)
        if causal:
            _mask_after(logits, i0, 0)
        p = logits.sub_(lse[:, i0:i0 + split, None]).exp_()
        ds = (doi @ vf[:, :c1].transpose(-1, -2)).sub_(
            delta[:, i0:i0 + split, None]).mul_(p)
        dk[:, :c1] += ds.transpose(-1, -2) @ qi
        dv[:, :c1] += p.transpose(-1, -2) @ doi
        del logits, p, ds
    return (scale * dk).to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors.
# ---------------------------------------------------------------------------
def flash_fwd(q, k, v, causal: bool, scale: float):
    """-> (O [BH, S, D] in q.dtype, LSE [BH, S] float32)."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal, scale)
    bh, s, d = _check_cuda("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v), (o, lse), (), scale, int(causal))
    return o, lse


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool, scale: float):
    """-> (dQ in q.dtype, delta = rowsum(dO * O) [BH, S] float32)."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, o, lse, do, causal, scale)
    bh, s, d = _check_cuda("flash_bwd_dq", q, k, v, o, do)
    _check_rows("flash_bwd_dq", bh, s, lse)
    dq = torch.empty_like(q)
    delta = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq", (q, k, v, o, do, lse), (dq, delta), (), scale,
            int(causal))
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """-> (dK, dV) in the input dtype."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    bh, s, d = _check_cuda("flash_bwd_dkv", q, k, v, do)
    _check_rows("flash_bwd_dkv", bh, s, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", (q, k, v, do, lse, delta), (dk, dv), (), scale,
            int(causal))
    return dk, dv


def _split_tiles(s: int) -> Tuple[int, int]:
    """(split in tiles, number of splits) for a streaming launch."""
    split = _split_len(s)
    return split // TILE, -(-s // split)


def _workspace(n: int, q: torch.Tensor, *tail: int) -> torch.Tensor:
    """A float32 [n, B*H of one launch, S, *tail] workspace."""
    bh, s, _ = q.shape
    return torch.empty(n, min(bh, MAX_LAUNCH_BH), s, *tail,
                       dtype=torch.float32, device=q.device)


def flash_fwd_str(q, k, v, causal: bool, scale: float):
    """Streaming forward -> (O in q.dtype, LSE [BH, S] float32)."""
    if not q.is_cuda:
        return flash_fwd_str_plain(q, k, v, causal, scale)
    bh, s, d = _check_cuda("flash_fwd_str", q, k, v)
    tiles, n = _split_tiles(s)
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    m_ws, l_ws = _workspace(n, q), _workspace(n, q)
    acc_ws = _workspace(n, q, d)
    _launch("flash_fwd_str", (q, k, v), (o, lse), (m_ws, l_ws, acc_ws),
            scale, int(causal), tiles)
    return o, lse


def flash_bwd_dq_str(q, k, v, o, lse, do, causal: bool, scale: float):
    """Streaming dQ -> (dQ in q.dtype, delta = rowsum(dO * O) [BH, S])."""
    if not q.is_cuda:
        return flash_bwd_dq_str_plain(q, k, v, o, lse, do, causal, scale)
    bh, s, d = _check_cuda("flash_bwd_dq_str", q, k, v, o, do)
    _check_rows("flash_bwd_dq_str", bh, s, lse)
    tiles, n = _split_tiles(s)
    dq = torch.empty_like(q)
    delta = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq_str", (q, k, v, o, do, lse), (dq, delta),
            (_workspace(n, q, d),), scale, int(causal), tiles)
    return dq, delta


def flash_bwd_dkv_str(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Streaming dK/dV -> (dK, dV) in the input dtype."""
    if not q.is_cuda:
        return flash_bwd_dkv_str_plain(q, k, v, do, lse, delta, causal,
                                       scale)
    bh, s, d = _check_cuda("flash_bwd_dkv_str", q, k, v, do)
    _check_rows("flash_bwd_dkv_str", bh, s, lse, delta)
    tiles, n = _split_tiles(s)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv_str", (q, k, v, do, lse, delta), (dk, dv),
            (_workspace(n, q, d), _workspace(n, q, d)), scale, int(causal),
            tiles)
    return dk, dv


def _use_streaming(q: torch.Tensor, streaming: Optional[bool]) -> bool:
    """The JAX package's rule: streaming when K+V (2 * S * D * itemsize)
    exceed RESIDENT_VMEM_BUDGET, unless ``streaming`` says otherwise."""
    if streaming is not None:
        return streaming
    _bh, s, d = q.shape
    return 2 * s * d * q.element_size() > RESIDENT_VMEM_BUDGET


def _attend_fwd(q, k, v, causal: bool, scale: float, streaming: bool):
    fwd = flash_fwd_str if streaming else flash_fwd
    return fwd(q, k, v, causal, scale)


def _attend_bwd(q, k, v, o, lse, do, causal: bool, scale: float,
                streaming: bool):
    bwd_dq, bwd_dkv = ((flash_bwd_dq_str, flash_bwd_dkv_str) if streaming
                       else (flash_bwd_dq, flash_bwd_dkv))
    dq, delta = bwd_dq(q, k, v, o, lse, do, causal, scale)
    dk, dv = bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# What a FLOP counter (torch.utils.flop_counter.FlopCounterMode, the device
# plane's MFU) reads.  The kernels launch through ctypes, outside the
# dispatcher, so the counter would see none of their work on the card, and
# on the CPU the plain versions' dense products, masked half included.
# Under a counter the forward and the backward therefore run as one custom
# op each, whose FLOP formula counts the visible query-key pairs as the
# kernels' bound does: 4 FLOPs per pair and head-dim element for the
# forward, 6 for dQ and 8 for dK/dV, whichever family or version runs.  The
# counter leaves its mode while an op it counts runs, so the plain versions'
# products inside are not counted again.  Without a counter the ops are not
# called: the dispatcher's cost stays off the hot path.
# ---------------------------------------------------------------------------
@torch.library.custom_op("byteps_tpu_torch::flash_attn_fwd", mutates_args=())
def _counted_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: float, streaming: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _attend_fwd(q, k, v, causal, scale, streaming)


@torch.library.custom_op("byteps_tpu_torch::flash_attn_bwd", mutates_args=())
def _counted_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 causal: bool, scale: float, streaming: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _attend_bwd(q, k, v, o, lse, do, causal, scale, streaming)


def _visible_pairs(bh: int, s: int, causal: bool) -> int:
    """Query-key pairs the softmax keeps: S (S + 1) / 2 a row of B*H
    under causal masking, S^2 without."""
    return bh * (s * (s + 1) // 2 if causal else s * s)


@register_flop_formula(torch.ops.byteps_tpu_torch.flash_attn_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    bh, s, d = q_shape
    return 4 * _visible_pairs(bh, s, causal) * d


@register_flop_formula(torch.ops.byteps_tpu_torch.flash_attn_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
               causal, *args, **kwargs) -> int:
    bh, s, d = q_shape
    return (6 + 8) * _visible_pairs(bh, s, causal) * d


def _counting() -> bool:
    """Whether a FLOP counter is active on this thread."""
    if not torch._C._len_torch_dispatch_stack():
        return False
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, _COUNTER_MODES)
               for m in _get_current_dispatch_mode_stack())


class _FlashAttention(torch.autograd.Function):
    """The custom_vjp of the JAX version: forward saves (q, k, v, O, LSE),
    backward runs the dQ kernel (which also yields delta), then dK/dV, of
    the family the forward ran."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, streaming):
        q, k, v = (t.contiguous() for t in (q, k, v))
        fwd = _counted_fwd if _counting() else _attend_fwd
        o, lse = fwd(q, k, v, causal, scale, streaming)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.streaming = causal, scale, streaming
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _counted_bwd if _counting() else _attend_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                         ctx.scale, ctx.streaming)
        return dq, dk, dv, None, None, None


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a caller's ``d`` at: the smallest of
    HEAD_DIMS not below it, and above MAX_HEAD_DIM the next multiple of
    WIDE_COLS (264 -> 384, 512 -> 512).  No upper limit: a D the card's
    memory cannot hold fails in the allocator."""
    for hd in HEAD_DIMS:
        if d <= hd:
            return hd
    return -(-d // WIDE_COLS) * WIDE_COLS


def _pad_head_dim(attn, q, k, v):
    """``attn(q, k, v)`` on q, k, v zero-padded on the last axis up to
    ``kernel_head_dim(D)``, its output sliced back to D.  Zero columns
    leave Q K^T, and so P, unchanged, and make the padded columns of O
    zero; autograd slices dQ, dK and dV back through the pad, and their
    padded columns are zero too.  ``attn`` takes the softmax scale from
    the caller's D, not the padded one.  CPU tensors take the same
    padding, so the plain versions see the shapes the kernels would."""
    d = q.shape[-1]
    pad = kernel_head_dim(d) - d
    if not pad:
        return attn(q, k, v)
    q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    return attn(q, k, v)[..., :d]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    interpret: Optional[bool] = None,
                    streaming: Optional[bool] = None) -> torch.Tensor:
    """Blockwise (flash) attention.  q, k, v: [BH, S, D] -> [BH, S, D].

    sm_scale defaults to 1/sqrt(D).  block_q/block_k are the JAX version's
    TPU tiling hints: they must divide S, as there, and are otherwise
    unused — the CUDA kernels pick their own 64-row tiles.
    streaming=None picks the family as the JAX package does (resident while
    2*S*D*itemsize fits RESIDENT_VMEM_BUDGET, streaming beyond), on the
    caller's D; True or False forces one.  D is zero-padded up to the next
    head dim the kernels take (``kernel_head_dim``, ``_pad_head_dim``).
    ``interpret`` is accepted for API parity; the tensors'
    device alone decides between the kernels (CUDA) and the plain versions
    (CPU).
    """
    del interpret
    if any(is_dtensor(t) for t in (q, k, v)):
        # The kernels take raw pointers to one rank's memory: a DTensor
        # would hand them its local block under its global shape.
        raise TypeError(
            "flash_attention takes plain tensors; for DTensors call "
            "models.transformer.flash_attention_fn, which runs the kernels "
            "on each rank's block through local_map")
    s, d = q.shape[1], q.shape[2]
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq_len {s} must divide block_q={block_q}, block_k={block_k}"
            " — use models.transformer.flash_attention_fn for the"
            " auto-fallback to dense attention")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    streaming = _use_streaming(q, streaming)
    return _pad_head_dim(lambda q, k, v: _FlashAttention.apply(
        q, k, v, causal, scale, streaming), q, k, v)
