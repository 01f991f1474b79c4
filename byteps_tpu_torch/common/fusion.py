"""Bucket composition for the collective plane, the eager API and the
wire.

Copies of ``byteps_tpu/common/fusion.py``'s planners and its streaming
buffer:

  - ``plan_segments``, the collective plane's: leaves are packed, and large
    leaves split, into buckets of at most ``capacity_elems`` elements,
    walking the leaves from the tail (the first gradients out of the
    backward pass) when ``reverse`` is set;
  - ``plan_buckets``, the eager ``push_pull_tree``'s: leaves below the
    fusion threshold pack into dtype-homogeneous buckets in reverse
    backprop order, each bucket one wire name at the max priority of its
    members; larger leaves go solo at their own priority;
  - ``plan_row_batches``, the row-sparse embedding pull's: row lookups
    coalesced into the fewest wire units under a byte cap;
  - ``FusionBuffer``, the streaming face for producers that see one
    gradient at a time (backward hooks): small tensors accumulate into
    per-dtype open buckets, concatenated with ``torch.cat`` on the
    leaves' device, that flush when full, when drained, or
    ``BYTEPS_TPU_FUSION_FLUSH_MS`` after they opened.

Their counters match the reference's.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

ZERO_STATS: Dict[str, int] = {
    "plans_used": 0,            # fusion plans applied to a dispatch
    "buckets_built": 0,         # fused buckets dispatched
    "leaves_fused": 0,          # leaves that rode a fused bucket
    "leaves_solo": 0,           # leaves >= threshold (own key, own priority)
    "fused_bytes": 0,           # payload bytes that rode fused buckets
    "solo_bytes": 0,            # payload bytes that rode solo keys
    "wire_messages_saved": 0,   # per-leaf chains avoided: fused - buckets
    "full_flushes": 0,          # streaming buckets closed by the size cap
    "deadline_flushes": 0,      # streaming buckets closed by FLUSH_MS
    "drain_flushes": 0,         # streaming buckets closed by flush()/close()
    "ingraph_plans": 0,         # collective-plane BucketPlans built
    "ingraph_buckets": 0,       # buckets in those plans
    "row_batch_plans": 0,       # sparse row-pull batching plans built
    "row_batches": 0,           # batched row-pull wire units in them
}

_stats = dict(ZERO_STATS)
_stats_lock = threading.Lock()


def _bump(**kw) -> None:
    with _stats_lock:
        for k, v in kw.items():
            _stats[k] += v


def get_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


def plan_segments(sizes: Sequence[int], capacity_elems: int,
                  reverse: bool = True) -> List[List[Tuple[int, int, int]]]:
    """Split/pack leaves into buckets of ``capacity_elems``, spilling large
    leaves across buckets.  Each bucket is ``[(leaf_idx, start, length)]``.
    """
    order = list(range(len(sizes)))
    if reverse:
        order.reverse()
    buckets: List[List[Tuple[int, int, int]]] = []
    cur: List[Tuple[int, int, int]] = []
    cur_n = 0
    for li in order:
        remaining = sizes[li]
        start = 0
        while remaining > 0:
            take = min(remaining, capacity_elems - cur_n)
            cur.append((li, start, take))
            start += take
            remaining -= take
            cur_n += take
            if cur_n >= capacity_elems:
                buckets.append(cur)
                cur, cur_n = [], 0
    if cur:
        buckets.append(cur)
    _bump(ingraph_plans=1, ingraph_buckets=len(buckets))
    return buckets


class Bucket:
    """One fused dispatch unit: a dtype-homogeneous run of small leaves.
    ``members`` is ``((leaf_idx, num_elems), ...)`` in pack order;
    ``priority`` is the max member index (its backprop position)."""

    __slots__ = ("index", "dtype", "members", "num_elems", "nbytes",
                 "priority", "sig")

    def __init__(self, index: int, dtype: str,
                 members: Tuple[Tuple[int, int], ...], itemsize: int):
        self.index = index
        self.dtype = dtype
        self.members = members
        self.num_elems = sum(n for _, n in members)
        self.nbytes = self.num_elems * itemsize
        self.priority = max(li for li, _ in members)
        self.sig = hashlib.md5(
            "|".join(f"{li}:{n}" for li, n in members).encode()
        ).hexdigest()[:8]

    @property
    def tag(self) -> str:
        """Wire-name suffix, a pure function of the member composition."""
        return f"fb{self.index}.{self.dtype}x{self.num_elems}.{self.sig}"


class FusionPlan:
    """``buckets`` by descending priority (the order they go out);
    ``solo``: ``((leaf_idx, priority), ...)`` for leaves at or above the
    threshold."""

    def __init__(self, buckets: Tuple[Bucket, ...],
                 solo: Tuple[Tuple[int, int], ...], fusion_bytes: int,
                 solo_bytes: int):
        self.buckets = buckets
        self.solo = solo
        self.fusion_bytes = fusion_bytes
        self.fused_bytes = sum(b.nbytes for b in buckets)
        self.solo_bytes = solo_bytes
        self.leaves_fused = sum(len(b.members) for b in buckets)

    def record_use(self) -> None:
        _bump(plans_used=1,
              buckets_built=len(self.buckets),
              leaves_fused=self.leaves_fused,
              leaves_solo=len(self.solo),
              fused_bytes=self.fused_bytes,
              solo_bytes=self.solo_bytes,
              wire_messages_saved=max(
                  0, self.leaves_fused - len(self.buckets)))


@functools.lru_cache(maxsize=256)
def plan_buckets(items: Tuple[Tuple[int, int, str, int], ...],
                 fusion_bytes: int) -> FusionPlan:
    """The (cached) plan for ``items`` = ``((leaf_idx, num_elems,
    dtype_str, itemsize), ...)`` in forward order.  Leaves of
    ``fusion_bytes`` or more go solo; the rest pack into per-dtype buckets
    of at most ``fusion_bytes``, scanning in reverse so that bucket 0
    holds the latest leaves."""
    solo: List[Tuple[int, int]] = []
    solo_bytes = 0
    open_members: Dict[str, List[Tuple[int, int]]] = {}
    open_bytes: Dict[str, int] = {}
    open_itemsize: Dict[str, int] = {}
    buckets: List[Bucket] = []

    def close(dtype: str) -> None:
        buckets.append(Bucket(len(buckets), dtype,
                              tuple(open_members.pop(dtype)),
                              open_itemsize[dtype]))
        open_bytes.pop(dtype)

    for li, n, dtype, itemsize in reversed(items):
        nbytes = n * itemsize
        if fusion_bytes <= 0 or nbytes >= fusion_bytes:
            solo.append((li, li))
            solo_bytes += nbytes
            continue
        if dtype in open_members and open_bytes[dtype] + nbytes > fusion_bytes:
            close(dtype)
        open_members.setdefault(dtype, []).append((li, n))
        open_bytes[dtype] = open_bytes.get(dtype, 0) + nbytes
        open_itemsize[dtype] = itemsize
    for dtype in sorted(open_members,
                        key=lambda d: -max(li for li, _ in open_members[d])):
        close(dtype)
    buckets.sort(key=lambda b: -b.priority)
    for i, b in enumerate(buckets):
        b.index = i
    solo.sort(key=lambda s: -s[1])
    return FusionPlan(tuple(buckets), tuple(solo), fusion_bytes, solo_bytes)


def plan_row_batches(nrows: int, row_width: int, max_bytes: int,
                     overhead_bytes: int = 32) -> List[Tuple[int, int]]:
    """Batching plan for row-sparse embedding pulls: coalesce ``nrows``
    row lookups (each ``row_width`` f32 elements on the response leg)
    into the fewest wire units whose response payload stays under
    ``max_bytes``.  Returns half-open ``(start, stop)`` slices over the
    caller's sorted index array.

    ``overhead_bytes`` covers the sparse header + param_version trailer;
    the index stream itself is elias-coded and strictly smaller than the
    row payload, so the row leg is the binding term.  A single row wider
    than the cap still ships alone — a lookup can never be split.
    """
    if nrows <= 0:
        return []
    row_bytes = max(1, int(row_width) * 4)
    per_batch = max(1, (max(1, int(max_bytes)) - overhead_bytes)
                    // row_bytes)
    batches = [(start, min(nrows, start + per_batch))
               for start in range(0, nrows, per_batch)]
    _bump(row_batch_plans=1, row_batches=len(batches))
    return batches


class FusionBuffer:
    """Streaming fusion accumulator with a deadline flush.

    Incremental gradient producers (backward hooks) cannot hand the
    planner a whole tree; they ``add()`` tensors as backprop emits them.
    Small tensors accumulate into open buckets, one per dtype and device,
    that flush when full (``fusion_bytes``) and ``flush_ms`` milliseconds
    after they opened even when not full, so a straggler tail (the front
    layers' last few biases) never waits for members that are not coming
    (``BYTEPS_TPU_FUSION_FLUSH_MS``; 0 turns the deadline off).

    ``dispatch(packed, members, priority)`` receives the concatenated
    flat tensor (``torch.cat`` on the leaves' device), ``[(name, shape,
    num_elems), ...]`` scatter metadata with each member's original shape
    as a tuple, and the bucket priority (the max member priority).
    Tensors at or above the threshold dispatch at once on their own, as
    flat views.  Dispatch always runs outside the buffer's lock.
    """

    def __init__(self, dispatch: Callable[[Any, list, int], None],
                 fusion_bytes: Optional[int] = None,
                 flush_ms: Optional[float] = None):
        from .config import get_config
        cfg = get_config()
        self.dispatch = dispatch
        self.fusion_bytes = (cfg.fusion_bytes if fusion_bytes is None
                             else int(fusion_bytes))
        self.flush_ms = (cfg.fusion_flush_ms if flush_ms is None
                         else float(flush_ms))
        # (dtype, device) -> [(name, flat, orig_shape, priority)]
        self._open: Dict[Tuple[str, str], list] = {}
        self._open_bytes: Dict[Tuple[str, str], int] = {}
        self._opened_at: Dict[Tuple[str, str], float] = {}
        self._cv = threading.Condition()
        self._closed = False
        self._flusher = None
        if self.flush_ms > 0 and self.fusion_bytes > 0:
            self._flusher = threading.Thread(
                target=self._deadline_loop, daemon=True,
                name="bps-fusion-flush")
            self._flusher.start()

    def add(self, name: str, tensor, priority: int = 0) -> None:
        flat = tensor.detach().reshape(-1)
        nbytes = flat.numel() * flat.element_size()
        shape = tuple(tensor.shape)
        if self.fusion_bytes <= 0 or nbytes >= self.fusion_bytes:
            _bump(leaves_solo=1, solo_bytes=nbytes)
            self.dispatch(flat, [(name, shape, flat.numel())], priority)
            return
        key = (str(flat.dtype), str(flat.device))
        flushed = None
        with self._cv:
            if self._closed:
                raise RuntimeError("FusionBuffer is closed")
            if (key in self._open
                    and self._open_bytes[key] + nbytes > self.fusion_bytes):
                flushed = self._take_locked(key, "full_flushes")
            if key not in self._open:
                self._open[key] = []
                self._open_bytes[key] = 0
                self._opened_at[key] = time.monotonic()
                self._cv.notify_all()     # wake the deadline flusher
            self._open[key].append((name, flat, shape, priority))
            self._open_bytes[key] += nbytes
        if flushed is not None:
            self.dispatch(*flushed)

    def _take_locked(self, key: Tuple[str, str], counter: str) -> tuple:
        """Pop one open bucket and build its dispatch payload.  The caller
        must call self.dispatch(*result) after releasing the lock: a
        dispatch can block on the wire for seconds, and holding the lock
        through it would stall every concurrent add() and the deadline
        flusher."""
        import torch
        members = self._open.pop(key)
        nbytes = self._open_bytes.pop(key)
        self._opened_at.pop(key)
        flats = [f for _, f, _, _ in members]
        packed = torch.cat(flats) if len(flats) > 1 else flats[0]
        meta = [(nm, shape, f.numel()) for nm, f, shape, _ in members]
        prio = max(p for _, _, _, p in members)
        _bump(buckets_built=1, leaves_fused=len(members),
              fused_bytes=nbytes,
              wire_messages_saved=len(members) - 1, **{counter: 1})
        return packed, meta, prio

    def flush(self) -> None:
        """Flush every open bucket now (end of the backward pass)."""
        with self._cv:
            flushed = [self._take_locked(k, "drain_flushes")
                       for k in list(self._open)]
        for f in flushed:
            self.dispatch(*f)

    def _deadline_loop(self) -> None:
        while True:
            flushed = []
            with self._cv:
                while not self._closed and not self._opened_at:
                    self._cv.wait()
                if self._closed:
                    return
                now = time.monotonic()
                deadline = min(self._opened_at.values()) \
                    + self.flush_ms / 1e3
                if now < deadline:
                    self._cv.wait(timeout=deadline - now)
                    continue
                for key in [k for k, t in list(self._opened_at.items())
                            if now >= t + self.flush_ms / 1e3]:
                    flushed.append(
                        self._take_locked(key, "deadline_flushes"))
            for f in flushed:
                self.dispatch(*f)

    def close(self) -> None:
        """Drain the open buckets and stop the deadline flusher."""
        with self._cv:
            if self._closed:
                flushed = []
            else:
                flushed = [self._take_locked(k, "drain_flushes")
                           for k in list(self._open)]
                self._closed = True
                self._cv.notify_all()
        for f in flushed:
            self.dispatch(*f)
        if self._flusher is not None:
            self._flusher.join(timeout=5)
