"""Compressed distributed gradient reduction.

Counterpart of ``byteps_tpu/ops/compressor/reduce.py``: the reference's
compressed push-pull without a server hop.  Each rank compresses its
bucket, the payloads are all-gathered (the words travel as int32), every
rank decompresses the W payloads with one batched call (one unpack launch
whatever W is) and sums them, and a bidirectional compressor re-quantizes
the sum with a server-side state, so the result is what a PS round trip
would give.

Buckets are the collective plane's (``collectives.bucketed_tree_all_reduce``
through its ``bucket_transform`` hook), so the bucket plan is
``collectives._plan_cache``'s, the JAX package's.  Each rank holds its own
worker and server state: the per-worker state that the JAX package emulates
by tiling and sharding over the mesh axis.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ...common.config import get_config
from ...common.tree import tree_leaves
from .. import collectives
from .base import InterCompressor

Tree = Any


def server_side(compressor: InterCompressor) -> InterCompressor:
    """The compressor the 'server' leg runs: momentum stripped, matching the
    reference registry's server instantiation."""
    from .decorators import NesterovMomentum
    while isinstance(compressor, NesterovMomentum):
        compressor = compressor.inner
    return compressor


def _bucket_sizes(tree: Tree, partition_bytes: Optional[int]) -> List[int]:
    """Element counts of the tree's buckets, from shapes alone."""
    leaves = [l for l in tree_leaves(tree) if l.numel() > 0]
    if not leaves:
        return []
    comm_dtype = collectives._comm_dtype([l.dtype for l in leaves])
    plan = collectives._plan_cache(
        tuple(l.numel() for l in leaves),
        partition_bytes or get_config().partition_bytes,
        comm_dtype.itemsize, True)
    return [sum(length for _, _, length in b) for b in plan.buckets]


def init_compression_state(tree: Tree, compressor: InterCompressor,
                           partition_bytes: Optional[int] = None) -> Any:
    """Per-bucket compressor state for a gradient tree, on the tree's
    device: the worker side plus, for bidirectional compressors, a
    server-side requantization state.  Only the leaves' sizes, dtypes and
    device are read."""
    sizes = _bucket_sizes(tree, partition_bytes)
    dev = tree_leaves(tree)[0].device if sizes else None
    worker = tuple(compressor.init_state(n, device=dev) for n in sizes)
    srv = server_side(compressor)
    server = tuple(srv.init_state(n, device=dev) for n in sizes) \
        if compressor.bidirectional else None
    return {"worker": worker, "server": server}


def compressed_tree_all_reduce(
    tree: Tree,
    compressor: InterCompressor,
    state: Any = None,
    group=None,
    average: bool = True,
    partition_bytes: Optional[int] = None,
    two_way: Optional[bool] = None,
) -> Tuple[Tree, Any]:
    """All-reduce ``tree`` over ``group`` with compressed wire traffic.

    Returns (reduced_tree, new_state).  ``state`` must come from
    ``init_compression_state`` (or be None for stateless compressors).
    ``two_way=None`` defaults to the compressor's bidirectional flag.
    """
    if not any(l.numel() for l in tree_leaves(tree)):
        return tree, state
    if two_way is None:
        two_way = compressor.bidirectional
    if state is None:
        state = init_compression_state(tree, compressor, partition_bytes)
    srv = server_side(compressor)
    new_worker, new_server = [], []

    def reduce_bucket(buf: torch.Tensor, bi: int) -> torch.Tensor:
        n = buf.numel()
        if compressor.payload_bytes(n) >= n * buf.element_size():
            # Compression would EXPAND this bucket (the sign stream's
            # 512-byte tile floor): ship it raw.
            new_worker.append(state["worker"][bi])
            if two_way:
                # Keep server-state alignment with the compressed path,
                # which appends one entry per bucket whenever two_way.
                new_server.append(state["server"][bi]
                                  if state["server"] is not None
                                  else srv.init_state(n, device=buf.device))
            return collectives.all_reduce(buf, group)
        payload, wst = compressor.compress(buf, state["worker"][bi])
        new_worker.append(wst)
        # push: every rank ships its payload to every rank ("the server").
        gathered = {k: collectives.all_gather(v, group, axis=0, tiled=False)
                    for k, v in payload.items()}
        summed = compressor.decompress(gathered, n).sum(0)
        if two_way:
            # Server-side requantize before the pull leg (momentum
            # stripped, as the reference server does).
            sst = state["server"][bi] if state["server"] is not None \
                else srv.init_state(n, device=buf.device)
            payload2, sst = srv.compress(summed, sst)
            summed = srv.decompress(payload2, n)
            new_server.append(sst)
        return summed

    # The bucketed reduce averages what reduce_bucket returns when asked.
    reduced = collectives.bucketed_tree_all_reduce(
        tree, group=group, average=average, partition_bytes=partition_bytes,
        bucket_transform=reduce_bucket)
    new_state = {"worker": tuple(new_worker),
                 "server": tuple(new_server) if new_server else
                 state.get("server")}
    return reduced, new_state


def compression_ratio(tree: Tree, compressor: InterCompressor,
                      partition_bytes: Optional[int] = None) -> float:
    """Raw bytes / wire bytes for one push leg (telemetry helper)."""
    sizes = _bucket_sizes(tree, partition_bytes)
    raw = sum(n * 4 for n in sizes)
    wire = sum(compressor.payload_bytes(n) for n in sizes)
    return raw / max(wire, 1)
