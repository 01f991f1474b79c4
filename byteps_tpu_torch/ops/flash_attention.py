"""Flash attention: hand-written Hopper kernels, forward and backward.

Counterpart of ``byteps_tpu/ops/flash_attention.py``.  Attention is computed
blockwise with an online softmax, so no [S, S] logits tensor is ever stored,
and the backward recomputes the probabilities from the saved log-sum-exp.
The kernels live in ``csrc/flash_attention.cu`` (see its header for the
tiling and what bounds each kernel on the H100):

  - ``flash_fwd``      q, k, v -> O (input dtype), LSE [BH, S] float32
  - ``flash_bwd_dq``   q, k, v, O, LSE, dO -> dQ, delta = rowsum(dO * O)
  - ``flash_bwd_dkv``  q, k, v, dO, LSE, delta -> dK, dV

Each wrapper runs its kernel for CUDA tensors and the plain PyTorch version
beside it (``*_plain``) for CPU tensors; for a CUDA tensor it launches the
kernel or raises.  ``launches`` counts kernel launches per wrapper.

Layout: q, k, v are [BH, S, D] (batch*heads folded), as in the JAX package.
The JAX version stores LSE as [BH, 1, S] for TPU tiling; here it is [BH, S].
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

SOURCE = "flash_attention.cu"
TILE = 64                      # the kernels' q and k tile (rows)
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernels are instantiated for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset_launches(), per wrapper.
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "bps_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "bps_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _F, _I, _P],
    "bps_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _I, _P],
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
                        f"kernel (float32, bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not supported by the CUDA "
                         f"kernel {HEAD_DIMS}")
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


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        msg = lib.bps_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    s = scale * (q.float() @ k.float().transpose(-1, -2))
    if causal:
        s = _causal_mask(s)
    p = torch.exp(s - lse[..., None])
    dp = do.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    delta = (do.float() * o.float()).sum(-1)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    return (scale * (ds @ k.float())).to(q.dtype), delta


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dk = scale * (ds.transpose(-1, -2) @ q.float())
    dv = p.transpose(-1, -2) @ do.float()
    return dk.to(k.dtype), dv.to(v.dtype)


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
    lib = _lib()
    err = lib.bps_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), bh, s, d,
                            _DTYPE_CODES[q.dtype], scale, int(causal),
                            _stream(q))
    _raise_on(lib, "flash_fwd", err)
    launches["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool, scale: float):
    """-> (dQ in q.dtype, delta = rowsum(dO * O) [BH, S] float32)."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, o, lse, do, causal, scale)
    bh, s, d = _check_cuda("flash_bwd_dq", q, k, v, o, do)
    _check_rows("flash_bwd_dq", bh, s, lse)
    dq = torch.empty_like(q)
    delta = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.bps_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               dq.data_ptr(), delta.data_ptr(), bh, s, d,
                               _DTYPE_CODES[q.dtype], scale, int(causal),
                               _stream(q))
    _raise_on(lib, "flash_bwd_dq", err)
    launches["flash_bwd_dq"] += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """-> (dK, dV) in the input dtype."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    bh, s, d = _check_cuda("flash_bwd_dkv", q, k, v, do)
    _check_rows("flash_bwd_dkv", bh, s, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib()
    err = lib.bps_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), bh, s, d,
                                _DTYPE_CODES[q.dtype], scale, int(causal),
                                _stream(q))
    _raise_on(lib, "flash_bwd_dkv", err)
    launches["flash_bwd_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom_vjp of the JAX version: forward saves (q, k, v, O, LSE),
    backward runs the dQ kernel (which also yields delta), then dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    interpret: Optional[bool] = None,
                    streaming: Optional[bool] = None) -> torch.Tensor:
    """Blockwise (flash) attention.  q, k, v: [BH, S, D] -> [BH, S, D].

    sm_scale defaults to 1/sqrt(D).  block_q/block_k are the JAX version's
    TPU tiling hints: they must divide S, as there, and are otherwise
    unused — the CUDA kernels pick their own 64-row tiles.  ``interpret``
    and ``streaming`` are accepted for API parity; the tensors' device alone
    decides between the kernels (CUDA) and the plain version (CPU).
    """
    del interpret, streaming
    s, d = q.shape[1], q.shape[2]
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq_len {s} must divide block_q={block_q}, block_k={block_k}"
            " — use models.transformer.flash_attention_fn for the"
            " auto-fallback to dense attention")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    return _FlashAttention.apply(q, k, v, causal, scale)
