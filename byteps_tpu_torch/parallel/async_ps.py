"""Asynchronous PS training: workers push weight deltas, no round barrier.

Counterpart of ``byteps_tpu/parallel/async_ps.py``, the workers' side of
the servers' ``BYTEPS_ENABLE_ASYNC`` mode: each worker runs its local
optimizer step, pushes the weight *delta* (w_new - w_old), and the server
applies ``store += delta`` at once, with no synchronization across
workers.  The pull returns the server's current global weights, which
replace the worker's local view (async SGD: a worker may compute on
slightly stale weights).

The trainer takes a tree (nested dicts and lists) of tensors and flattens
it once, in ``jax.tree.leaves``' order (``common.tree``), into one float32
vector on the host, where the wire is: so the keys, the partitions and the
wire bytes equal the JAX package's for the same tree.  ``params`` hands the
view back as tensors on the caller's devices, in the caller's dtypes.

Wire layout: with fusion on (``BYTEPS_TPU_FUSION_BYTES`` > 0, the default)
the fusion planner (``common.fusion``) packs small leaves into size-capped
buckets in reverse backprop order and leaves large ones on their own keys,
each dispatched at its backprop-position priority through
``PSSession.push_pull_group``; ``fusion_bytes=0``, or a session without
``push_pull_group``, sends the single flat vector.

Pipelining (the default): ``step()`` dispatches the new delta and waits
only for the *previous* round, so each round's round trip overlaps the
next step's local compute.  Consecutive rounds share partition keys, so
the session's sequential-use guard orders round k+1's dispatch after round
k's pull.  Each pushed delta is the pure local movement, so nothing is
counted twice: the adopted view is ``global_after_previous_round +
own_in_flight_movement``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from ..common.tree import FlatHost
from .hierarchy import maybe_reducer, not_ported_reducer

Tree = Any


class AsyncPSTrainer:
    """Weight-delta async training against servers in async mode.

    Usage (servers run with ``BYTEPS_ENABLE_ASYNC=1``)::

        trainer = AsyncPSTrainer(session, params, name="model")
        for batch in data:
            updated = local_step(trainer.params, batch)   # any optimizer
            trainer.step(updated)        # push the delta, adopt the view
        final = trainer.finalize()       # drain the round in flight

    ``pipeline=False`` is the synchronous push -> wait -> adopt cycle.
    ``hierarchy`` (the hierarchical reducer) is not ported: a value, or
    ``BYTEPS_TPU_HIERARCHY=1``, raises ``NotImplementedError``.
    """

    def __init__(self, session, params: Tree, name: str = "async_param",
                 declared_key: Optional[int] = None, pipeline: bool = True,
                 fusion_bytes: Optional[int] = None, hierarchy=None):
        if getattr(session, "server_async", True) is False:
            raise RuntimeError(
                "AsyncPSTrainer requires servers running with "
                "BYTEPS_ENABLE_ASYNC=1; against a sync server the weight-"
                "delta protocol would silently train on deltas")
        if hierarchy is not None:
            raise not_ported_reducer()
        maybe_reducer(session)
        self._session = session
        self._pipeline = pipeline
        self._view = FlatHost(params)
        self._sizes = self._view.sizes
        if declared_key is None:
            from ..common.api import _session_declare
            declared_key = _session_declare(f"AsyncParam.{name}")
        self._key = declared_key
        self._chunks = self._plan_chunks(name, fusion_bytes)
        # The round in flight: (handle, its movement); at most one.
        self._pending = None
        # Seed the store with the initial weights.  A seed applies only to
        # a key never pushed, so a late or rejoining worker adopts the live
        # global weights from the pull instead of resetting them.
        self._flat = self._dispatch(self._view.flatten(params), seed=True
                                    ).wait().astype(np.float32)

    def _plan_chunks(self, name: str, fusion_bytes: Optional[int]):
        """[(declared_key, flat_ranges, priority)] in priority-descending
        dispatch order, or None for the single-key layout.  Chunk keys come
        from the buckets' deterministic tags, so every worker (and a
        restarted one) maps the same parameters to the same keys."""
        from ..common import fusion
        from ..common.api import _session_declare
        from ..common.config import get_config

        fb = (get_config().fusion_bytes if fusion_bytes is None
              else int(fusion_bytes))
        if fb <= 0 or len(self._sizes) < 2 \
                or not hasattr(self._session, "push_pull_group"):
            return None
        plan = fusion.plan_buckets(
            tuple((i, n, "float32", 4) for i, n in enumerate(self._sizes)),
            fb)
        plan.record_use()
        offs = np.concatenate([[0], np.cumsum(self._sizes)]).astype(np.int64)
        # The resolved key is in the chunk names, so trainers kept apart by
        # an explicit declared_key stay apart on the wire.
        base = f"AsyncParam.{name}.k{self._key}"
        chunks = []
        for b in plan.buckets:
            ranges = [(int(offs[li]), int(offs[li]) + n)
                      for li, n in b.members]
            chunks.append((_session_declare(f"{base}.{b.tag}"), ranges,
                           b.priority))
        for li, prio in plan.solo:
            chunks.append((_session_declare(f"{base}.leaf{li}"),
                           [(int(offs[li]), int(offs[li + 1]))], prio))
        if len(chunks) < 2:
            return None
        chunks.sort(key=lambda c: -c[2])
        return chunks

    def _dispatch(self, flat: np.ndarray, seed: bool = False):
        """Push one round's flat payload; the returned handle's
        ``wait(timeout)`` gives the assembled global flat vector."""
        if self._chunks is None:
            return self._session.push_pull_async(self._key, flat, seed=seed)
        items = [(key, _gather(flat, ranges), prio)
                 for key, ranges, prio in self._chunks]
        handles = self._session.push_pull_group(items, seed=seed)
        return _GroupRoundHandle(handles, self._chunks, len(flat))

    @property
    def params(self) -> Tree:
        """The current local view (last adopted global weights plus the
        movement in flight), as the caller's tree."""
        return self._view.unflatten(self._flat)

    def step(self, updated_params: Tree) -> Tree:
        """Push the local movement (updated - current view) as a delta.

        Pipelined: dispatch the new delta, then wait for the PREVIOUS
        round's pull, which had the whole local step that produced
        ``updated_params`` to complete.  The adopted view is
        ``global_after_prev + in_flight_movement``; the server has the
        movement already, so nothing is counted twice."""
        new_flat = self._view.flatten(updated_params)
        delta = new_flat - self._flat
        handle = self._dispatch(delta)
        if not self._pipeline:
            self._flat = handle.wait().astype(np.float32)
            return self.params
        prev, self._pending = self._pending, (handle, delta)
        if prev is not None:
            g = prev[0].wait().astype(np.float32)
            # g is the server after our previous round; our newest movement
            # is still in flight, so it stays in the local view.
            self._flat = g + delta
        else:
            self._flat = new_flat
        return self.params

    def finalize(self, timeout: Optional[float] = 300.0) -> Tree:
        """Drain the round in flight and adopt the pure global weights."""
        if self._pending is not None:
            handle, _delta = self._pending
            self._pending = None
            self._flat = handle.wait(timeout).astype(np.float32)
        return self.params

    # -- elastic input-pipeline re-sharding (docs/elasticity.md) ----------
    def data_shard(self, membership: Optional[dict] = None) -> tuple:
        """``(shard_index, shard_count)`` for this worker's input pipeline:
        its position among the SORTED alive ids, so shards stay dense after
        a join or an eviction; with no view (or epoch 0) the launch
        ``(worker_id, num_worker)``."""
        wid = int(getattr(self._session, "worker_id", 0))
        if membership is None or int(membership.get("epoch", 0)) == 0:
            from ..common.config import get_config
            return wid, max(1, int(get_config().num_worker))
        alive = sorted(int(w) for w in membership.get("alive", ()))
        if not alive:
            return 0, 1
        if wid not in alive:
            # Evicted: moot, but well-formed for the shutdown paths.
            return 0, len(alive)
        return alive.index(wid), len(alive)

    def membership_callback(self, on_reshard):
        """A ``callback(membership)`` for ``on_membership_change`` that calls
        ``on_reshard(shard_index, shard_count, membership)`` exactly when
        this worker's shard moved; epoch bumps that leave it alone stay
        quiet."""
        state = {"shard": self.data_shard()}

        def _cb(membership):
            shard = self.data_shard(membership)
            if shard != state["shard"]:
                state["shard"] = shard
                on_reshard(shard[0], shard[1], membership)

        return _cb

    def enable_reshard(self, on_reshard, poll_s: Optional[float] = None):
        """Register ``membership_callback(on_reshard)`` with the API's
        membership poller (``bps.on_membership_change``; needs ``init()`` in
        PS mode) and return it."""
        from ..common import api
        cb = self.membership_callback(on_reshard)
        api.on_membership_change(cb, poll_s)
        return cb


def _gather(flat: np.ndarray, ranges) -> np.ndarray:
    """The flat-vector slices a chunk covers, concatenated (a view for a
    single run)."""
    if len(ranges) == 1:
        a, b = ranges[0]
        return flat[a:b]
    return np.concatenate([flat[a:b] for a, b in ranges])


class _GroupRoundHandle:
    """One round's chunked dispatch as a single handle: waits every chunk
    and scatters the pulled values back into one flat float32 vector."""

    def __init__(self, handles, chunks, n: int):
        self._handles = handles
        self._chunks = chunks
        self._n = n

    def done(self) -> bool:
        return all(h.done() for h in self._handles)

    def wait(self, timeout: Optional[float] = 300.0) -> np.ndarray:
        # One deadline for the whole round, not one per chunk.
        deadline = None if timeout is None else time.monotonic() + timeout
        out = np.empty(self._n, np.float32)
        for h, (_key, ranges, _prio) in zip(self._handles, self._chunks):
            left = (None if deadline is None
                    else max(0.001, deadline - time.monotonic()))
            got = np.asarray(h.wait(left), np.float32).ravel()
            off = 0
            for a, b in ranges:
                out[a:b] = got[off:off + (b - a)]
                off += b - a
        return out
