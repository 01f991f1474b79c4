"""Bucket composition for the collective plane and the eager API.

Copies of ``byteps_tpu/common/fusion.py``'s two planners:

  - ``plan_segments``, the collective plane's: leaves are packed, and large
    leaves split, into buckets of at most ``capacity_elems`` elements,
    walking the leaves from the tail (the first gradients out of the
    backward pass) when ``reverse`` is set;
  - ``plan_buckets``, the eager ``push_pull_tree``'s: leaves below the
    fusion threshold pack into dtype-homogeneous buckets in reverse
    backprop order, each bucket one wire name at the max priority of its
    members; larger leaves go solo at their own priority.

Their counters match the reference's.
"""

from __future__ import annotations

import functools
import hashlib
import threading
from typing import Dict, List, Sequence, Tuple

ZERO_STATS: Dict[str, int] = {
    "plans_used": 0,            # fusion plans applied to a dispatch
    "buckets_built": 0,         # fused buckets dispatched
    "leaves_fused": 0,          # leaves that rode a fused bucket
    "leaves_solo": 0,           # leaves >= threshold (own key, own priority)
    "fused_bytes": 0,           # payload bytes that rode fused buckets
    "solo_bytes": 0,            # payload bytes that rode solo keys
    "wire_messages_saved": 0,   # per-leaf chains avoided: fused - buckets
    "ingraph_plans": 0,         # collective-plane BucketPlans built
    "ingraph_buckets": 0,       # buckets in those plans
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
