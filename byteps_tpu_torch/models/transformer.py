"""Transformer language model (the flagship model family) in PyTorch.

Counterpart of ``byteps_tpu/models/transformer.py``: the same configs, the
same parameter tree (stacked ``[L, ...]`` layer leaves under the same keys,
so ``params_from_numpy`` carries JAX parameters across unchanged) and the
same math: layernorm/rmsnorm in float32, float32 RoPE, GQA by repeating kv
heads, tanh-gelu or swiglu, a weight-tied readout with float32 logits, the
streamed LM-head cross-entropy, and per-layer rematerialisation.

Parameters are a plain tree (nested dicts of leaf tensors with
``requires_grad``); ``common.tree.tree_leaves`` lists them in the JAX
package's order, which is the order optimizers and the bucket plan use.
Under the sharded step (``parallel/sharded.py``) the leaves are DTensors
placed by ``param_specs`` (Megatron TP); the attention and the streamed
LM head then run per rank on plain tensors through ``local_map``
(``_attend_sharded``, ``_sharded_nll_sum``), the rest on DTensor's rules.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common.device import DeviceLike, is_dtensor, resolve_device
from ..common.tree import tree_leaves
from ..parallel.sharded import PartitionSpec as P

Tree = Any


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # master params stay f32
    causal: bool = True                # decoder LM; False = BERT-style encoder
    norm: str = "layernorm"            # "layernorm" | "rmsnorm"
    act: str = "gelu"                  # "gelu" | "swiglu"
    pos: str = "learned"               # "learned" | "rope"
    rope_theta: float = 10000.0
    num_kv_heads: Optional[int] = None  # GQA/MQA: < num_heads; None = MHA
    use_bias: bool = True              # llama-class blocks drop biases
    remat: bool = True                 # per-layer rematerialisation
    # "none" recomputes each layer from its input in backward
    # (torch.utils.checkpoint); "proj" keeps qkv, attn_ctx and attn_proj,
    # "dots" every matmul output, "dots_no_batch" those without batch dims
    # (the JAX package's policies; see _remat_block).
    remat_policy: str = "none"
    attn_impl: str = "dense"           # "dense" | "flash"
    attn_block: int = 0                # flash block hint (0 = auto)
    attn_block_k: int = 0              # flash K block hint (0 = attn_block)
    # > 0 streams the LM head in row chunks of this size (fused_nll_sum).
    ce_chunk_rows: int = 0
    # The JAX layer scan's unroll factor; validated for parity, no effect
    # here (layers run as a Python loop).
    scan_unroll: int = 1

    def __post_init__(self):
        for field, val, allowed in (
                ("norm", self.norm, ("layernorm", "rmsnorm")),
                ("act", self.act, ("gelu", "swiglu")),
                ("pos", self.pos, ("learned", "rope"))):
            if val not in allowed:
                raise ValueError(f"{field}={val!r}; options: {allowed}")
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} not divisible by "
                             f"num_heads={self.num_heads}")
        if self.num_kv_heads is not None:
            if self.num_kv_heads < 1:
                raise ValueError("num_kv_heads must be >= 1 (or None for "
                                 "full multi-head attention)")
            if self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"num_heads={self.num_heads} not divisible by "
                    f"num_kv_heads={self.num_kv_heads} (GQA shares each kv "
                    f"head across an integer group of query heads)")
        if self.pos == "rope" and self.head_dim % 2:
            raise ValueError(f"pos='rope' needs an even head_dim "
                             f"(got {self.head_dim})")
        if self.ce_chunk_rows < 0:
            raise ValueError(f"ce_chunk_rows={self.ce_chunk_rows} must be "
                             f">= 0 (0 = unfused full-logits path)")
        if self.scan_unroll < 1 or self.num_layers % self.scan_unroll:
            raise ValueError(
                f"scan_unroll={self.scan_unroll} must be >= 1 and divide "
                f"num_layers={self.num_layers}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)


CONFIGS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(vocab_size=1024, num_layers=2, d_model=64,
                              num_heads=4, d_ff=128, max_seq_len=128),
    "bert_base": TransformerConfig(num_layers=12, d_model=768, num_heads=12,
                                   d_ff=3072, causal=False),
    "bert_large": TransformerConfig(num_layers=24, d_model=1024, num_heads=16,
                                    d_ff=4096, causal=False),
    "gpt_small": TransformerConfig(num_layers=12, d_model=768, num_heads=12,
                                   d_ff=3072, causal=True),
    "gpt_medium": TransformerConfig(num_layers=24, d_model=1024, num_heads=16,
                                    d_ff=4096, causal=True),
    "llama_tiny": TransformerConfig(vocab_size=1024, num_layers=2, d_model=64,
                                    num_heads=4, num_kv_heads=2, d_ff=160,
                                    max_seq_len=128, norm="rmsnorm",
                                    act="swiglu", pos="rope", use_bias=False),
    "llama_1b": TransformerConfig(vocab_size=32768, num_layers=16,
                                  d_model=2048, num_heads=32, num_kv_heads=8,
                                  d_ff=5504, max_seq_len=2048, norm="rmsnorm",
                                  act="swiglu", pos="rope", use_bias=False),
    "llama_300m": TransformerConfig(vocab_size=32768, num_layers=24,
                                    d_model=1024, num_heads=16,
                                    num_kv_heads=4, d_ff=2816,
                                    max_seq_len=2048, norm="rmsnorm",
                                    act="swiglu", pos="rope", use_bias=False),
}


def get_config(name: str, **overrides) -> TransformerConfig:
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------
def param_shapes(cfg: TransformerConfig) -> Tree:
    """The parameter tree's shapes: init_params' tree without allocating."""
    L, D, F_ = cfg.num_layers, cfg.d_model, cfg.d_ff
    Dh, Hkv = cfg.head_dim, cfg.kv_heads
    qkv_cols = (cfg.num_heads + 2 * Hkv) * Dh
    layers = {
        "qkv_w": (L, D, qkv_cols),
        "attn_out_w": (L, cfg.num_heads * Dh, D),
        "mlp_in_w": (L, D, F_),
        "mlp_out_w": (L, F_, D),
        "ln1_scale": (L, D),
        "ln2_scale": (L, D),
    }
    if cfg.act == "swiglu":
        layers["mlp_gate_w"] = (L, D, F_)
    if cfg.use_bias:
        layers.update({"ln1_bias": (L, D), "ln2_bias": (L, D),
                       "qkv_b": (L, qkv_cols), "attn_out_b": (L, D),
                       "mlp_in_b": (L, F_), "mlp_out_b": (L, D)})
    out = {"embed": (cfg.vocab_size, D), "layers": layers,
           "ln_f_scale": (D,)}
    if cfg.pos == "learned":
        out["pos_embed"] = (cfg.max_seq_len, D)
    if cfg.use_bias:
        out["ln_f_bias"] = (D,)
    return out


# Weight matrices and their fan-in (the last dim but one); the rest of the
# tree starts at ones (norm scales) or zeros (biases).
_FAN_IN_INIT = ("embed", "qkv_w", "attn_out_w", "mlp_in_w", "mlp_out_w",
                "mlp_gate_w")


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: DeviceLike = None) -> Tree:
    """Random parameters from ``generator``: normal/sqrt(fan_in) weights,
    0.02-scaled learned positions, unit norm scales, zero biases — the JAX
    package's init, drawn from torch's generator (other numbers)."""
    dev = resolve_device(device)
    dt = cfg.param_dtype

    def make(name, shape):
        if name in _FAN_IN_INIT:
            fan_in = shape[-1] if name == "embed" else shape[-2]
            t = torch.randn(shape, generator=generator, dtype=dt,
                            device=generator.device) / math.sqrt(fan_in)
        elif name == "pos_embed":
            t = torch.randn(shape, generator=generator, dtype=dt,
                            device=generator.device) * 0.02
        elif name.endswith("_scale"):
            t = torch.ones(shape, dtype=dt)
        else:
            t = torch.zeros(shape, dtype=dt)
        return t.to(dev).requires_grad_()

    shapes = param_shapes(cfg)
    out = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return out


def params_from_numpy(tree: Tree, cfg: TransformerConfig,
                      device: DeviceLike = None) -> Tree:
    """The JAX package's parameter tree, as numpy arrays
    (``jax.tree.map(np.asarray, init_params(...))``), as this package's
    parameters: the same keys and shapes, in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def convert(node, want):
        if isinstance(want, dict):
            if set(node) != set(want):
                raise ValueError(f"param keys {sorted(node)} != expected "
                                 f"{sorted(want)}")
            return {k: convert(node[k], want[k]) for k in want}
        arr = np.asarray(node, dtype=np.float32)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"param shape {arr.shape} != expected {want}")
        return torch.tensor(arr, dtype=cfg.param_dtype,
                            device=dev).requires_grad_()

    return convert(tree, shapes)


def param_specs(cfg: TransformerConfig, tp_axis: str = "tp",
                pp_axis: Optional[str] = None) -> Tree:
    """PartitionSpec tree for Megatron-style TP (column/row split) with the
    stacked layer axis optionally sharded over the pipeline axis.

    Mirrors init_params' conditional keys (GQA/SwiGLU/no-bias/rope).  The
    GQA qkv layout ([q | k | v] flat columns) does not fall on head
    boundaries: under the sharded step the attention gathers qkv's columns
    before it splits heads (``_attend_sharded``), where the JAX package
    leaves the resharding to XLA.
    """
    pp = pp_axis  # leading stacked-layer dim
    layers = {
        "qkv_w": P(pp, None, tp_axis),
        "attn_out_w": P(pp, tp_axis, None),
        "mlp_in_w": P(pp, None, tp_axis),
        "mlp_out_w": P(pp, tp_axis, None),
        "ln1_scale": P(pp, None),
        "ln2_scale": P(pp, None),
    }
    if cfg.act == "swiglu":
        layers["mlp_gate_w"] = P(pp, None, tp_axis)
    if cfg.use_bias:
        layers.update({
            "ln1_bias": P(pp, None),
            "ln2_bias": P(pp, None),
            "qkv_b": P(pp, tp_axis),
            "attn_out_b": P(pp, None),
            "mlp_in_b": P(pp, tp_axis),
            "mlp_out_b": P(pp, None),
        })
    out = {
        "embed": P(None, None),
        "layers": layers,
        "ln_f_scale": P(None),
    }
    if cfg.pos == "learned":
        out["pos_embed"] = P(None, None)
    if cfg.use_bias:
        out["ln_f_bias"] = P(None)
    return out


# ---------------------------------------------------------------------------
# Forward pass.
# ---------------------------------------------------------------------------
def _layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)   # population variance
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _rms_norm(x, scale, bias, eps=1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


_NORMS = {"layernorm": _layer_norm, "rmsnorm": _rms_norm}


def _rope(x, theta: float, offset: int = 0):
    """Rotary position embedding on [B, H, S, Dh] (half-split layout) at
    positions offset .. offset + S - 1, in float32, cast back to the
    compute dtype after rotating."""
    B, H, S, Dh = x.shape
    half = Dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = torch.arange(offset, offset + S, dtype=torch.float32,
                          device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def dense_attention(q, k, v, causal: bool):
    """q, k, v: [B, H, S, Dh].  Softmax in f32; masked logits take the
    float32 minimum, as in the JAX package."""
    dh = q.shape[-1]
    logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(dh)
    if causal:
        s = q.shape[2]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return probs @ v


def flash_auto_block(S: int) -> int:
    """The flash adapter's auto block rule (the JAX package's, kept for
    parity): the full sequence at S <= 512, else the largest of
    512/256/128/64 dividing S; 0 when no 64-row block divides S."""
    if S <= 512:
        return S if S % 64 == 0 else 0
    for b in (512, 256, 128, 64):
        if S % b == 0:
            return b
    return 0


def flash_attention_fn(q, k, v, causal: bool, strict: bool = False,
                       block: int = 0, block_k: int = 0):
    """Adapter: [B, H, S, Dh] -> the flash kernels' [BH, S, Dh] layout, with
    a fallback to dense attention when S is not a multiple of 64 or Dh not
    a multiple of 8; ``strict=True`` raises instead.  Any other Dh runs on
    the kernels, zero-padded to the next head dim they take.  A block
    override that does not divide S or is not a multiple of 64 reverts to
    the auto choice, never to dense.  DTensor q, k, v run the same on each
    rank's block (``_local_attention``)."""
    if is_dtensor(q):
        return _local_attention(
            functools.partial(flash_attention_fn, strict=strict, block=block,
                              block_k=block_k), q, k, v, causal)
    B, H, S, Dh = q.shape
    if not block or S % block or block % 64:
        block = flash_auto_block(S)
    if not block_k or S % block_k or block_k % 64:
        block_k = block
    if block == 0 or Dh % 8:
        if strict:
            raise ValueError(
                f"flash attention needs seq_len divisible by 64 (got {S}) "
                f"and head_dim a multiple of 8 (got {Dh}); pad the "
                f"sequence or drop to attn='dense' explicitly")
        return dense_attention(q, k, v, causal)
    from ..ops.flash_attention import flash_attention

    def fold(t):
        return t.reshape(B * H, S, Dh)
    out = flash_attention(fold(q), fold(k), fold(v), causal, None,
                          block, block_k)
    return out.reshape(B, H, S, Dh)


def _local_attention(attn, q, k, v, causal: bool):
    """``attn(q, k, v, causal)`` on DTensors [B, H, S, Dh], each rank on
    its block through ``local_map``: a split batch or split heads stay as
    they are, any other placement (a split sequence or head dim, a pending
    sum) is gathered first; k and v take q's placements."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
          for p in q.placements]
    q, k, v = (t.redistribute(placements=pl) for t in (q, k, v))
    return local_map(functools.partial(attn, causal=causal),
                     out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh)(q, k, v)


_ATTN_IMPLS = {"dense": dense_attention, "flash": flash_attention_fn}


def _bias(lp: Dict[str, torch.Tensor], name: str, dt: torch.dtype):
    return lp[name].to(dt) if name in lp else None


def _add_bias(t, lp, name):
    b = _bias(lp, name, t.dtype)
    return t if b is None else t + b


# One transformer block in four pieces, cut at the tensors the JAX package
# names for its "proj" remat policy (qkv, attn_ctx, attn_proj, ffn_out).
def _qkv(x, lp: Dict[str, torch.Tensor], cfg: TransformerConfig):
    h = _NORMS[cfg.norm](x, lp["ln1_scale"], _bias(lp, "ln1_bias", cfg.dtype))
    return _add_bias(h @ lp["qkv_w"].to(cfg.dtype), lp, "qkv_b")


def _attend(qkv, cfg: TransformerConfig, attn_fn):
    """qkv [B, S, (H + 2 Hkv) Dh] -> the attention context [B, S, H Dh]."""
    if is_dtensor(qkv):
        return _attend_sharded(qkv, cfg, attn_fn)
    H, Hkv, Dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = torch.split(qkv, [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    return _attend_heads(q, k, v, cfg, attn_fn)


def seq_offset(attn_fn, S: int) -> int:
    """The position of this rank's first token: ``sp_index * S`` under an
    adaptor over blocks of a split sequence (``ops.ring_attention``), 0
    for attention over the whole sequence."""
    return getattr(attn_fn, "sp_index", 0) * S


def _attend_heads(q, k, v, cfg: TransformerConfig, attn_fn):
    """q [B, S, h Dh], k and v [B, S, hkv Dh] (h a multiple of hkv) ->
    the context of those h heads, [B, S, h Dh]."""
    B, S, _ = q.shape
    Dh = cfg.head_dim

    def heads(t):
        return t.reshape(B, S, -1, Dh).transpose(1, 2)
    q, k, v = heads(q), heads(k), heads(v)
    if cfg.pos == "rope":
        off = seq_offset(attn_fn, S)
        q, k = (_rope(q, cfg.rope_theta, off),
                _rope(k, cfg.rope_theta, off))
    if k.shape[1] != q.shape[1]:
        # GQA: each query-head group shares one kv head (jnp.repeat order).
        k = torch.repeat_interleave(k, q.shape[1] // k.shape[1], dim=1)
        v = torch.repeat_interleave(v, q.shape[1] // v.shape[1], dim=1)
    attn = attn_fn(q, k, v, cfg.causal)
    return attn.transpose(1, 2).reshape(B, S, -1)


def _attend_sharded(qkv, cfg: TransformerConfig, attn_fn):
    """``_attend`` on a DTensor qkv (the sharded step): each rank attends
    over its own block of plain tensors through ``local_map``, so the
    flash kernels launch on local memory.

    The batch keeps its split.  A mesh dim that splits qkv's columns
    (column-parallel ``qkv_w``) is gathered here, an explicit redistribute:
    the flat [q | k | v] columns do not fall on head boundaries.  The heads
    are then split over those mesh dims when H and Hkv divide by their
    product, each rank attending over its own heads (the context comes out
    split by columns, ready for the row-parallel ``attn_out_w``, and qkv's
    gradient is a sum over them); otherwise every rank attends over all
    heads.  Any other placement (a split sequence, a pending sum) is made
    whole first.  Heads, rope and GQA's repeat run inside, on local
    tensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = qkv.device_mesh
    last = qkv.ndim - 1
    H, Hkv, Dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    batch = [p.is_shard(0) for p in qkv.placements]
    col = [p.is_shard(last) for p in qkv.placements]
    n = math.prod(mesh.size(i) for i, c in enumerate(col) if c)
    split = n > 1 and H % n == 0 and Hkv % n == 0
    whole = [Shard(0) if b else Replicate() for b in batch]
    qkv = qkv.redistribute(placements=whole)
    idx = 0
    if split:
        coord = mesh.get_coordinate()
        for i, c in enumerate(col):
            if c:
                idx = idx * mesh.size(i) + coord[i]
    h, hkv = (H // n, Hkv // n) if split else (H, Hkv)

    def local(t):
        q, k, v = torch.split(t, [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
        return _attend_heads(q[..., idx * h * Dh:(idx + 1) * h * Dh],
                             k[..., idx * hkv * Dh:(idx + 1) * hkv * Dh],
                             v[..., idx * hkv * Dh:(idx + 1) * hkv * Dh],
                             cfg, attn_fn)

    out = [Shard(last) if c and split else w for c, w in zip(col, whole)]
    grad = [Partial() if c and split else w for c, w in zip(col, whole)]
    return local_map(local, out_placements=out, in_placements=(whole,),
                     in_grad_placements=(grad,), device_mesh=mesh)(qkv)


def _attn_proj(ctx, lp: Dict[str, torch.Tensor], cfg: TransformerConfig):
    return _add_bias(ctx @ lp["attn_out_w"].to(cfg.dtype), lp, "attn_out_b")


def _ffn(r, lp: Dict[str, torch.Tensor], cfg: TransformerConfig):
    """The MLP's output on the residual stream r."""
    dt = cfg.dtype
    h = _NORMS[cfg.norm](r, lp["ln2_scale"], _bias(lp, "ln2_bias", dt))
    up = _add_bias(h @ lp["mlp_in_w"].to(dt), lp, "mlp_in_b")
    if cfg.act == "swiglu":
        h = F.silu(h @ lp["mlp_gate_w"].to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return _add_bias(h @ lp["mlp_out_w"].to(dt), lp, "mlp_out_b")


def _residual_ffn(x, proj, lp: Dict[str, torch.Tensor],
                  cfg: TransformerConfig):
    """The block's output from its input x and attn_proj."""
    r = x + proj
    return r + _ffn(r, lp, cfg)


def _block(x, lp: Dict[str, torch.Tensor], cfg: TransformerConfig, attn_fn):
    """One transformer block.  x: [B, S, D]; lp: this layer's params."""
    proj = _attn_proj(_attend(_qkv(x, lp, cfg), cfg, attn_fn), lp, cfg)
    return _residual_ffn(x, proj, lp, cfg)


def _block_proj(x, lp, cfg: TransformerConfig, attn_fn):
    """``_block`` under the "proj" policy: each piece checkpointed, so that
    the backward keeps the block's input and qkv, attn_ctx and attn_proj,
    and recomputes the rest (the norms, the attention with its
    probabilities, the MLP's hidden layer) piece by piece.  ffn_out is
    named too, but no backward needs it (the residual add), as under the
    JAX policy, which keeps a named tensor only where the backward needs
    it."""
    qkv = checkpoint(_qkv, x, lp, cfg, use_reentrant=False)
    ctx = checkpoint(_attend, qkv, cfg, attn_fn, use_reentrant=False)
    proj = checkpoint(_attn_proj, ctx, lp, cfg, use_reentrant=False)
    return checkpoint(_residual_ffn, x, proj, lp, cfg, use_reentrant=False)


# The matrix products of the JAX package's "dots" policies as the
# dispatcher sees them: torch.matmul of [B, S, D] by [D, E] decomposes to
# mm (no batch dims), of [B, H, S, Dh] by [B, H, Dh, S] to bmm.
_DOT_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default),
}


class SavePolicy:
    """A selective-checkpoint policy: keep the outputs of ``ops``,
    recompute everything else.  The flash kernels launch through ctypes,
    outside the dispatcher, so no policy sees them: the recompute reruns
    the flash autograd op whole.  ``log``, when a list, records
    (is_recompute, op) for every op the policy is asked about, so a test
    can hold the forward's op sequence against the recompute's."""

    def __init__(self, ops, log: Optional[list] = None):
        self.ops = frozenset(ops)
        self.log = log

    def __call__(self, ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy
        if self.log is not None:
            self.log.append((ctx.is_recompute, op))
        return (CheckpointPolicy.MUST_SAVE if op in self.ops
                else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(policy: str, log: Optional[list] = None):
    """The per-layer function of a remat policy: (x, lp, cfg, attn_fn) ->
    the block's output."""
    if policy == "none":
        return lambda x, lp, cfg, attn_fn: checkpoint(
            _block, x, lp, cfg, attn_fn, use_reentrant=False)
    if policy == "proj":
        return _block_proj
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    context = functools.partial(create_selective_checkpoint_contexts,
                                SavePolicy(_DOT_OPS[policy], log))
    return lambda x, lp, cfg, attn_fn: checkpoint(
        _block, x, lp, cfg, attn_fn, use_reentrant=False,
        context_fn=context)


_REMAT_POLICIES = ("none", "dots", "dots_no_batch", "proj")


def forward_hidden(params: Tree, tokens: torch.Tensor,
                   cfg: TransformerConfig, attn_fn=None) -> torch.Tensor:
    """tokens [B, S] int -> final hidden states [B, S, D] (post ln_f).

    Under a sequence-parallel ``attn_fn`` (``ops.ring_attention``'s
    adaptors) ``tokens`` is this rank's block of the sequence and its
    positions start at ``seq_offset(attn_fn, S)``."""
    if attn_fn is None:
        if cfg.attn_impl not in _ATTN_IMPLS:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} needs an explicit attn_fn; "
                f"built-ins: {sorted(_ATTN_IMPLS)}")
        attn_fn = _ATTN_IMPLS[cfg.attn_impl]
        if cfg.attn_impl == "flash" and (cfg.attn_block
                                         or cfg.attn_block_k):
            attn_fn = functools.partial(flash_attention_fn,
                                        block=cfg.attn_block,
                                        block_k=cfg.attn_block_k)
    if cfg.remat:
        if cfg.remat_policy not in _REMAT_POLICIES:
            raise ValueError(f"remat_policy={cfg.remat_policy!r}; "
                             f"options: {sorted(_REMAT_POLICIES)}")
        layer = _remat_block(cfg.remat_policy)
    else:
        layer = _block
    dt = cfg.dtype
    S = tokens.shape[1]
    x = params["embed"].to(dt)[tokens]
    if cfg.pos == "learned":
        off = seq_offset(attn_fn, S)
        if off + S > cfg.max_seq_len:
            raise ValueError(
                f"positions {off}..{off + S - 1} run past max_seq_len="
                f"{cfg.max_seq_len} (learned positions)")
        x = x + params["pos_embed"].to(dt)[off:off + S]
    # One unbind per stacked leaf and forward, outside the checkpointed
    # blocks: indexing the [L, ...] leaf once per layer would make autograd
    # build a full-size zero gradient per layer.
    names = sorted(params["layers"])
    per_layer = zip(*(torch.unbind(params["layers"][n], 0) for n in names))
    for leaves in per_layer:
        x = layer(x, dict(zip(names, leaves)), cfg, attn_fn)
    return _NORMS[cfg.norm](x, params["ln_f_scale"], params.get("ln_f_bias"))


def _f32_logits(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """x [N, D] @ emb [V, D]^T with float32 logits from activation-dtype
    operands (the JAX package's ``preferred_element_type=float32``).

    Both operands are upcast to float32 before the product, on every
    device: the products of bf16 values are exact in float32, so this is
    bf16 operands with float32 accumulation.  (torch.mm's ``out_dtype``
    would keep bf16 tensor cores, but exists for CUDA only.)  On CUDA the
    float32 matmul runs in full float32 unless the caller enables TF32."""
    return x.float() @ emb.float().t()


def forward(params: Tree, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_fn=None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (f32), weight-tied readout."""
    x = forward_hidden(params, tokens, cfg, attn_fn=attn_fn)
    B, S, D = x.shape
    emb = params["embed"].to(x.dtype)
    return _f32_logits(x.reshape(B * S, D), emb).reshape(B, S, -1)


def _chunk_nll_sum(xc, tc, emb):
    logits = _f32_logits(xc, emb)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, tc[:, None])[:, 0]
    return (lse - tgt).sum()


def fused_nll_sum(x: torch.Tensor, embed: torch.Tensor,
                  targets: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """Streamed weight-tied LM cross-entropy: the SUM of per-row NLL without
    materialising the full [B*S, vocab] logits.  Rows go in chunks of
    ``chunk_rows``; each chunk is checkpointed, so backward recomputes its
    logits instead of saving them.  The last chunk may be shorter (the JAX
    version pads it with zero-weight rows; the sum is the same)."""
    if is_dtensor(x):
        return _sharded_nll_sum(x, embed, targets, chunk_rows)
    B, S, D = x.shape
    N = B * S
    C = min(chunk_rows, N)
    xs = x.reshape(N, D)
    ts = targets.reshape(N)
    emb = embed.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, N, C):
        total = total + checkpoint(_chunk_nll_sum, xs[start:start + C],
                                   ts[start:start + C], emb,
                                   use_reentrant=False)
    return total


def _sharded_nll_sum(x, embed, targets, chunk_rows: int):
    """``fused_nll_sum`` on DTensors: each rank streams its own rows
    through ``local_map`` (slicing a split batch into chunks would gather
    it, and the running sum starts from a plain zero), and the sum is
    pending (Partial) over the mesh dims that split the batch, as is the
    gradient of ``embed``, which every rank holds whole (gathered here when
    it is split).  Any placement of x other than a split batch is made
    whole first; targets take x's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    batch = [p.is_shard(0) for p in x.placements]
    rows = [Shard(0) if b else Replicate() for b in batch]
    whole = [Replicate()] * len(batch)
    summed = [Partial() if b else Replicate() for b in batch]
    x = x.redistribute(placements=rows)
    targets = targets.redistribute(placements=rows)
    embed = embed.redistribute(placements=whole)
    return local_map(
        functools.partial(fused_nll_sum, chunk_rows=chunk_rows),
        out_placements=summed, in_placements=(rows, whole, rows),
        in_grad_placements=(rows, summed, rows),
        device_mesh=x.device_mesh)(x, embed, targets)


def loss_fn(params: Tree, batch: Tuple[torch.Tensor, torch.Tensor],
            cfg: TransformerConfig, attn_fn=None) -> torch.Tensor:
    """Cross-entropy LM loss.  batch = (tokens [B, S], targets [B, S])."""
    tokens, targets = batch
    if cfg.ce_chunk_rows:
        x = forward_hidden(params, tokens, cfg, attn_fn=attn_fn)
        return fused_nll_sum(x, params["embed"], targets,
                             cfg.ce_chunk_rows) / targets.numel()
    logits = forward(params, tokens, cfg, attn_fn=attn_fn)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def num_params(params: Tree) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def flops_per_token(cfg: TransformerConfig) -> float:
    """Approximate training FLOPs/token (6N rule + attention)."""
    qkv_cols = (cfg.num_heads + 2 * cfg.kv_heads) * cfg.head_dim
    mlp_mats = 3 if cfg.act == "swiglu" else 2
    n = (cfg.num_layers * (cfg.d_model * qkv_cols
                           + cfg.num_heads * cfg.head_dim * cfg.d_model
                           + mlp_mats * cfg.d_model * cfg.d_ff)
         + cfg.vocab_size * cfg.d_model)
    attn = cfg.num_layers * 2 * cfg.max_seq_len * cfg.d_model
    return 6.0 * (n + attn)


def synthetic_batch(generator: torch.Generator, batch_size: int,
                    seq_len: int, cfg: TransformerConfig,
                    device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random token batch (tokens, next-token targets) from ``generator``."""
    dev = resolve_device(device)
    toks = torch.randint(0, cfg.vocab_size, (batch_size, seq_len + 1),
                         generator=generator, device=generator.device)
    toks = toks.to(dev)
    return toks[:, :-1], toks[:, 1:]
