"""Bucket composition for the collective plane.

``plan_segments`` is a copy of ``byteps_tpu/common/fusion.py:plan_segments``,
the one bucket-composition algorithm: leaves are packed, and large leaves
split, into buckets of at most ``capacity_elems`` elements, walking the
leaves from the tail (the first gradients out of the backward pass) when
``reverse`` is set.  Its counters match the reference's in-graph ones.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

ZERO_STATS: Dict[str, int] = {
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
