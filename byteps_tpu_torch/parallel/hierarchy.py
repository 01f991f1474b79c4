"""Hierarchical reduction over the PS tier: its slice topology.

Counterpart of ``byteps_tpu/parallel/hierarchy.py``'s topology helpers,
the part ``PSSession.slice_leader`` (``server/client.py``) reads.  Slices
are contiguous worker-id ranges: worker ``w`` belongs to slice
``w // slice_size``, and the leader of a slice is its lowest alive
member.  The reducer itself (slice-reduce on the card, leader-only wire
round, broadcast back) is ROADMAP.md Queue 1 item 6c: ``maybe_reducer``,
the trainers' opt-in, raises where the JAX package's would build one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


def slice_of(worker_id: int, slice_size: int) -> int:
    """The slice a worker id belongs to: contiguous ranges of
    ``slice_size`` ids (slice 0 = ids [0, S), slice 1 = [S, 2S), ...)."""
    s = max(1, int(slice_size))
    return int(worker_id) // s


def slice_members(slice_id: int, slice_size: int,
                  world: Optional[int] = None) -> List[int]:
    """The worker ids of one slice, clipped to ``world`` when given (the
    last slice of a non-multiple world is short, never padded)."""
    s = max(1, int(slice_size))
    lo = int(slice_id) * s
    hi = lo + s
    if world is not None:
        hi = min(hi, int(world))
    return list(range(lo, hi))


def elect_leader(members: Sequence[int],
                 alive: Optional[Sequence[int]] = None) -> Optional[int]:
    """The slice leader: the lowest alive member (None = launch set, all
    alive).  None when the whole slice has departed: the server then
    stops expecting the slice at the next epoch boundary."""
    pool = [int(m) for m in members]
    if alive is not None:
        live = {int(a) for a in alive}
        pool = [m for m in pool if m in live]
    return min(pool) if pool else None


def maybe_reducer(session) -> None:
    """The trainers' hierarchical opt-in (``BYTEPS_TPU_HIERARCHY=1`` with a
    session): None when off.  The reducer is not ported, so opting in
    raises ``NotImplementedError``."""
    import os

    if os.environ.get("BYTEPS_TPU_HIERARCHY", "0") != "1" or session is None:
        return None
    raise not_ported_reducer()


def not_ported_reducer() -> NotImplementedError:
    return NotImplementedError(
        "the hierarchical reducer (BYTEPS_TPU_HIERARCHY, hierarchy=) is "
        "not ported to byteps_tpu_torch yet (ROADMAP.md Queue 1 item 6c)")
