"""Row-sparse embedding tables: the PS tier as a lookup tier.

Counterpart of ``byteps_tpu/parallel/embedding.py``.  The dense planes move
whole tensors, so an embedding table would pay wire bytes for its FULL
size when a step touches 0.1% of its rows.  This is the workers' face of
the row-sparse plane (docs/sparse-embedding.md):

- the table lives on the servers, sharded row-wise across the PS tier
  (``shard = row % shards``: consecutive hot rows spread out), larger than
  any worker's memory;
- ``push_pull`` ships ``(indices, rows)`` pairs both ways, so wire bytes
  follow the touched rows, and the servers' row-wise optimizer (CMD_OPT)
  steps exactly the pushed rows, its slots made row by row on the server;
- ``lookup`` reads the last published rows through the session's
  param_version-keyed hot-row cache (unchanged hot rows cost no wire
  frame) and works from pull-only sessions, which never stall training.

Every shard is one wire key, which the ring places, drains and migrates
like any other.  Indices and gradients may be numpy arrays or tensors (on
any device); rows come back as float32 host arrays, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch


def _host(a, dtype) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


class EmbeddingTable:
    """A server-resident ``rows x width`` float32 embedding table.

    Usage::

        table = EmbeddingTable(session, rows=10_000_000, width=64,
                               name="user_emb",
                               opt_kwargs={"opt": "adagrad", "lr": 0.01},
                               init=init_fn)
        for batch in data:
            emb = table.lookup(batch.ids)           # batched, cached
            grads = grad_fn(emb, batch)
            table.push_pull(batch.ids, grads)       # sparse round step

    ``opt_kwargs`` arms the servers' row-wise optimizer (``adagrad``,
    ``adam``, ``momentum`` or ``sgd`` with their hyperparameters); ``init``
    seeds the rows, either a full ``(rows, width)`` array or a callable
    ``init(shard_rows, width, shard_idx)``, so that a large table is never
    whole on the worker.  Without ``opt_kwargs`` the table publishes each
    round's gradient SUMS.  A pull-only session builds the same table
    (declaration is idempotent) and uses ``lookup`` only.
    """

    def __init__(self, session, rows: int, width: int,
                 name: str = "embedding",
                 shards: Optional[int] = None,
                 opt_kwargs: Optional[dict] = None,
                 init: Any = None):
        if rows <= 0 or width <= 0:
            raise ValueError(f"embedding shape must be positive, got "
                             f"{rows}x{width}")
        from ..common.api import _session_declare
        self._session = session
        self.rows, self.width = int(rows), int(width)
        self.name = name
        nsrv = max(1, len(getattr(session, "conns", [])) or 1)
        self.shards = max(1, min(int(shards) if shards else nsrv,
                                 self.rows))
        self._keys: List[int] = []
        self._shard_rows: List[int] = []
        for s in range(self.shards):
            key = _session_declare(f"Embed.{name}.{s}")
            # Shard s holds the rows r with r % shards == s, at local index
            # r // shards: ceil((rows - s) / shards) of them.
            srows = (self.rows - s + self.shards - 1) // self.shards
            session.declare_embedding(key, srows, self.width)
            self._keys.append(key)
            self._shard_rows.append(srows)
        if opt_kwargs:
            if getattr(session, "pull_only", False):
                raise RuntimeError(
                    "a pull-only session cannot arm the optimizer "
                    "(it is a reader); arm from a trainer session")
            for s, key in enumerate(self._keys):
                session.arm_embedding(key, dict(opt_kwargs),
                                      table=self._shard_init(init, s))

    def _shard_init(self, init: Any, s: int) -> Optional[np.ndarray]:
        if init is None:
            return None
        if callable(init):
            t = _host(init(self._shard_rows[s], self.width, s), np.float32)
        else:
            full = _host(init, np.float32)
            if full.shape != (self.rows, self.width):
                raise ValueError(f"init shape {full.shape} != "
                                 f"{(self.rows, self.width)}")
            t = full[s::self.shards]
        if t.shape != (self._shard_rows[s], self.width):
            raise ValueError(f"shard {s} init shape {t.shape} != "
                             f"{(self._shard_rows[s], self.width)}")
        return t

    def _split(self, indices):
        idx = np.ascontiguousarray(_host(indices, np.int64).ravel())
        if idx.size and (idx.min() < 0 or idx.max() >= self.rows):
            raise IndexError(f"row index out of range for {self.rows}"
                             f"-row table")
        shard = idx % self.shards
        local = (idx // self.shards).astype(np.uint32)
        return idx, shard, local

    def push_pull(self, indices, grads) -> np.ndarray:
        """One sparse training step: merge this worker's ``(indices,
        grads)`` into the open round of EVERY shard (an untouched shard
        gets an EMPTY sparse push, so that its round never waits on a
        shard this batch missed), wait for the publishes, and return the
        published rows for ``indices`` in the caller's order (updated
        parameters when armed, the round's sums otherwise).  Duplicate
        indices accumulate on the push and get the same row back."""
        idx, shard, local = self._split(indices)
        g = np.ascontiguousarray(_host(grads, np.float32))
        g = g.reshape(idx.size, self.width)
        out = np.empty((idx.size, self.width), dtype=np.float32)
        for s, key in enumerate(self._keys):
            mask = shard == s
            out[mask] = self._session.push_pull_sparse(key, local[mask],
                                                       g[mask])
        return out

    def lookup(self, indices) -> np.ndarray:
        """Batched row read against the last PUBLISHED table state: not
        gated on a round, cached hot rows cost no wire frame, and shards no
        requested row lands on are not contacted.  Works from pull-only
        sessions."""
        idx, shard, local = self._split(indices)
        out = np.empty((idx.size, self.width), dtype=np.float32)
        for s, key in enumerate(self._keys):
            mask = shard == s
            if not mask.any():
                continue
            out[mask] = self._session.pull_rows(key, local[mask])
        return out

    @property
    def keys(self) -> List[int]:
        """The declared key of each shard."""
        return list(self._keys)

    @property
    def table_bytes(self) -> int:
        """The float32 bytes the table holds across the PS tier."""
        return self.rows * self.width * 4

    def versions(self) -> List[Optional[int]]:
        """The last param_version seen per shard (None: never read);
        non-decreasing per shard."""
        return [self._session.embed_version(k) for k in self._keys]
