"""Input pipeline helpers: rank sharding and device prefetch.

Counterpart of ``byteps_tpu/utils/data.py``.  The JAX package shards over a
device mesh; here a worker is one process and one card, so the batch is
sliced over the workers' rank and world (a two-level mesh,
``parallel/mesh.py``, lays its ranks out row-major, so rank r holds shard
r there too):

  - ``host_shard`` / ``shard_batch``: this rank's contiguous rows of a
    global batch;
  - ``global_batch_from_local``: the global batch gathered from every
    rank's local rows, in rank order;
  - ``prefetch_to_device``: pinned host memory and a side CUDA stream, so
    step N+1's copy overlaps step N's compute.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Iterable, Iterator, Optional

import torch

from ..common.device import DeviceLike, resolve_device

Tree = Any


def _map(fn, tree: Tree) -> Tree:
    """``fn`` on every tensor of a batch: nested tuples, lists and dicts."""
    if isinstance(tree, tuple):
        return tuple(_map(fn, t) for t in tree)
    if isinstance(tree, list):
        return [_map(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _world(rank: Optional[int], size: Optional[int]):
    # The process group's rank, not ``rank()``: the BYTEPS_GLOBAL_RANK
    # override can diverge from it, and global_batch_from_local assembles
    # in process-group order, as the JAX package slices by process index.
    from ..common.api import process_rank, size as _size
    return (process_rank() if rank is None else rank,
            _size() if size is None else size)


def host_shard(batch: Tree, rank: Optional[int] = None,
               size: Optional[int] = None) -> Tree:
    """This worker's contiguous rows [rank * per, (rank + 1) * per) of a
    global batch (every leaf's dim 0), per = rows / size.  rank and size
    default to the process group's."""
    rank, size = _world(rank, size)

    def slc(x):
        n = x.shape[0]
        if n % size:
            raise ValueError(
                f"global batch dim {n} is not divisible by world size "
                f"{size}")
        per = n // size
        return x[rank * per:(rank + 1) * per]

    return _map(slc, batch)


def shard_batch(batch: Tree, device: DeviceLike = None,
                rank: Optional[int] = None,
                size: Optional[int] = None) -> Tree:
    """``host_shard`` of a global batch, moved to ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    return _map(lambda x: x.to(dev, non_blocking=True),
                    host_shard(batch, rank, size))


def global_batch_from_local(batch: Tree) -> Tree:
    """The global batch from each worker's local rows (the inverse of
    ``host_shard``): every leaf all-gathered along dim 0 in rank order.
    A world of one gives the batch back."""
    from ..common.api import size
    if size() == 1:
        return batch
    import torch.distributed as dist

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, 0)

    return _map(gather, batch)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: DeviceLike = None) -> Iterator:
    """Keep ``size`` batches in flight to the device.  On CUDA each batch is
    copied from pinned host memory on a side stream, and the consumer's
    stream waits for that copy before the batch is handed out."""
    dev = resolve_device(device)
    it = iter(iterator)
    queue: collections.deque = collections.deque()
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        if stream is None:
            return _map(lambda x: x.to(dev), batch), None
        batch = _map(lambda x: x.pin_memory() if x.device.type == "cpu"
                     else x, batch)
        with torch.cuda.stream(stream):
            moved = _map(lambda x: x.to(dev, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(stream)
        return moved, done

    for batch in itertools.islice(it, size):
        queue.append(put(batch))
    while queue:
        batch, done = queue.popleft()
        if done is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(done)
            _map(lambda x: x.record_stream(current), batch)
        yield batch
        for nxt in itertools.islice(it, 1):
            queue.append(put(nxt))


def synthetic_batches(make_batch, n: Optional[int] = None) -> Iterator:
    """Endless (or n-long) stream of ``make_batch(i)``."""
    counter = itertools.count() if n is None else range(n)
    for i in counter:
        yield make_batch(i)
