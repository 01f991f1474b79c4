"""Sequence-parallel attention: ring and Ulysses.

Counterpart of ``byteps_tpu/ops/ring_attention.py``.  Each rank of a
process ``group`` (None: the default group) holds its block of the sequence,
[B, H, S_local, D], where the JAX functions run per shard under
``shard_map`` over a mesh ``axis_name``.  Under ``collectives.local_mode()``,
or in a world of one, the permutations and all-to-alls are the identity.

The adaptors (``make_ring_attn_fn``, ``make_ulysses_attn_fn``) know which
block their rank holds (``SeqBlockAttn.sp_index``), so that
``models.transformer.forward(params, local_tokens, cfg, attn_fn=...)``
numbers the block's positions globally, as the JAX adaptors' callers do on
the whole sequence.

  - Ring: Q stays put, K/V blocks travel around the ring
    (``collectives.ppermute``) while each rank merges its queries' attention
    over every block with an online softmax.
  - Ulysses: one all-to-all turns the sequence shards into head shards
    [B, H/n, S, D], attention runs over the whole sequence locally, and a
    second all-to-all restores the sequence shards.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from ..models import transformer as _tfm
from . import collectives

NEG_INF = torch.finfo(torch.float32).min


def _block_attn(q, k, v, mask):
    """One blockwise attention contribution with running-max bookkeeping.

    q: [B,H,Sq,D], k/v: [B,H,Sk,D], mask: [Sq,Sk] bool (True = attend).
    Returns (out_unnorm [B,H,Sq,D] f32, m, l): the partial numerator and
    the softmax statistics (row max, row sum) for online combination.
    """
    d = q.shape[-1]
    logits = (q @ k.transpose(-1, -2)).float()
    logits = logits / math.sqrt(d)
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(-1, keepdim=True)                  # [B,H,Sq,1]
    # All-masked rows: keep m finite so exp() is well-behaved.
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(logits - m_safe).masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)                        # [B,H,Sq,1]
    o = p.to(q.dtype) @ v
    return o.float(), m_safe, l


def block_index(group=None) -> int:
    """The index of this rank's sequence block in ``group``: its rank
    there, 0 in local mode or a world of one."""
    return dist.get_rank(group) if collectives.axis_size(group) > 1 else 0


def ring_attention_shard(q, k, v, causal: bool, group=None):
    """Ring attention over this rank's sequence block.

    q, k, v: [B, H, S_local, D], block ``rank`` of a ring of
    ``axis_size(group)`` ranks.  Returns [B, H, S_local, D].
    """
    n = collectives.axis_size(group)
    my = block_index(group)
    B, H, S, D = q.shape
    q_pos = my * S + torch.arange(S, device=q.device)
    o = torch.zeros(B, H, S, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S, 1), NEG_INF / 2, device=q.device)
    l = torch.zeros(B, H, S, 1, device=q.device)
    kv = torch.stack([k, v])
    for t in range(n):
        # After t steps this rank holds the block of rank (my - t) mod n.
        if causal:
            kv_pos = ((my - t) % n) * S + torch.arange(S, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
        else:
            mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
        o_t, m_t, l_t = _block_attn(q, kv[0], kv[1], mask)
        # Online-softmax merge of (o, m, l) with the new block's stats.
        m_new = torch.maximum(m, m_t)
        c_old, c_new = torch.exp(m - m_new), torch.exp(m_t - m_new)
        o = o * c_old + o_t * c_new
        l = l * c_old + l_t * c_new
        m = m_new
        if t < n - 1:
            kv = collectives.ppermute(kv, 1, group)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


class SeqBlockAttn:
    """An ``attn_fn(q, k, v, causal)`` over this rank's block of a sequence
    split across ``group``, which knows the block: ``sp_index`` and
    ``sp_size`` are the block's index and the number of blocks.
    ``models.transformer`` reads ``sp_index`` to number the block's
    positions from ``sp_index * S_local`` (learned positions and rope)."""

    def __init__(self, shard_fn, group=None, **kwargs):
        self._fn = functools.partial(shard_fn, group=group, **kwargs)
        self.group = group

    def __call__(self, q, k, v, causal: bool):
        return self._fn(q, k, v, causal)

    @property
    def sp_index(self) -> int:
        return block_index(self.group)

    @property
    def sp_size(self) -> int:
        return collectives.axis_size(self.group)


def make_ring_attn_fn(group=None) -> SeqBlockAttn:
    """An ``attn_fn(q, k, v, causal)`` for ``models.transformer.forward``
    running ring attention over this rank's sequence block.  The model
    takes this rank's tokens, [B, S_local], and numbers their positions
    globally through the adaptor's ``sp_index``, so its output is this
    rank's block of the unsharded forward."""
    return SeqBlockAttn(ring_attention_shard, group)


def ulysses_attention_shard(q, k, v, causal: bool, group=None, attn=None):
    """Ulysses attention over this rank's sequence block.

    q, k, v: [B, H, S/n, D].  An all-to-all turns them into [B, H/n, S, D]
    (the whole sequence, a subset of heads), ``attn`` (default: dense)
    runs locally, and a second all-to-all restores sequence sharding.
    Needs num_heads % n == 0.
    """
    n = collectives.axis_size(group)
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses needs num_heads ({q.shape[1]}) divisible by the sp "
            f"axis size ({n}); use ring attention otherwise")

    def seq_to_heads(x):
        return collectives.all_to_all(x, 1, 2, group)

    out = (attn or _tfm.dense_attention)(seq_to_heads(q), seq_to_heads(k),
                                         seq_to_heads(v), causal)
    return collectives.all_to_all(out, 2, 1, group)


def make_ulysses_attn_fn(group=None, attn="dense") -> SeqBlockAttn:
    """Ulysses counterpart of make_ring_attn_fn: the model on this rank's
    tokens, positions numbered globally, gives this rank's block of the
    unsharded forward.

    ``attn`` picks the attention over the gathered sequence: "dense",
    "flash" (the flash kernels: Ulysses hands each rank the whole sequence
    for a subset of heads, so this is the long-context pairing; it raises
    rather than fall back to dense, whose S x S logits it exists to avoid),
    or any callable (q, k, v, causal)."""
    if callable(attn):
        inner = attn
    elif attn not in _tfm._ATTN_IMPLS:
        raise ValueError(f"attn must be a callable or one of "
                         f"{sorted(_tfm._ATTN_IMPLS)}; got {attn!r}")
    elif attn == "flash":
        inner = functools.partial(_tfm.flash_attention_fn, strict=True)
    else:
        inner = _tfm._ATTN_IMPLS[attn]
    return SeqBlockAttn(ulysses_attention_shard, group, attn=inner)
