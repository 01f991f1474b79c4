"""The host core: tensor registry, keys, partitions, placement hashes,
async handles, the push/pull speed window and the trace recorder.

Counterpart of ``byteps_tpu/core/native.py``, whose ``_PyCore`` is the
pure-Python twin of ``byteps_tpu/core/core.cc``; this is that class's
semantics, kept in plain Python.  The C++ core is built for the port only
when the PS tier needs it (ROADMAP.md Queue 1 item 6).

  - Declared names get dense keys 0, 1, 2, ... in declaration order; the
    registry survives ``suspend``/``resume``, so keys stay stable.
  - Partition ``p`` of declared key ``k`` travels as ``k << 16 | p``
    (core.cc ``bps_encode_key``); ``partition_bounds`` cuts a tensor's
    bytes into pieces of at most ``partition_bytes`` (core.cc:134).
  - ``key_to_server`` places a key on a server with the hashes of
    core.cc:149-181: djb2 (and ``built_in``), sdbm, ``mixed`` (their XOR)
    over the key's decimal digits, or ``naive`` (the key itself).
  - Handles are allocated 0, 1, 2, ...; ``handle_poll`` is -1 for a handle
    never allocated or already released, 0 while pending, 1 when done.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional, Tuple

_MASK64 = 0xFFFFFFFFFFFFFFFF


def _djb2(s: str) -> int:
    h = 5381
    for c in s:
        h = (((h << 5) + h) + ord(c)) & _MASK64
    return h


def _sdbm(s: str) -> int:
    h = 0
    for c in s:
        h = (ord(c) + (h << 6) + (h << 16) - h) & _MASK64
    return h


class Core:
    def __init__(self):
        self.trace_on = False
        self._name2key: dict = {}
        self._names: List[str] = []
        self._lock = threading.Lock()
        self._tel_events: list = []
        self._tel_window_us = 10_000_000
        self._trace_events: list = []
        self._next_handle = 0
        self._handles: dict = {}

    # -- registry ----------------------------------------------------------
    def declare_tensor(self, name: str) -> int:
        with self._lock:
            if name in self._name2key:
                return self._name2key[name]
            key = len(self._names)
            self._name2key[name] = key
            self._names.append(name)
            return key

    def get_declared_key(self, name: str) -> int:
        with self._lock:
            return self._name2key.get(name, -1)

    def num_declared(self) -> int:
        with self._lock:
            return len(self._names)

    def declared_name(self, idx: int) -> Optional[str]:
        with self._lock:
            return self._names[idx] if 0 <= idx < len(self._names) else None

    def reset_registry(self) -> None:
        with self._lock:
            self._name2key.clear()
            self._names.clear()

    # -- keys, partitions, placement ---------------------------------------
    @staticmethod
    def encode_key(declared_key: int, part_idx: int) -> int:
        return (declared_key << 16) | (part_idx & 0xFFFF)

    @staticmethod
    def decode_key(key: int) -> Tuple[int, int]:
        return key >> 16, key & 0xFFFF

    @staticmethod
    def partition_bounds(nbytes: int,
                         partition_bytes: int) -> List[Tuple[int, int]]:
        if nbytes <= 0:
            return [(0, max(nbytes, 0))]
        out, off = [], 0
        while off < nbytes:
            ln = min(partition_bytes, nbytes - off)
            out.append((off, ln))
            off += ln
        return out

    @staticmethod
    def key_to_server(key: int, num_servers: int,
                      hash_fn: str = "djb2") -> int:
        if num_servers <= 0:
            return 0
        s = str(key)
        if hash_fn == "naive":
            h = key
        elif hash_fn == "sdbm":
            h = _sdbm(s)
        elif hash_fn == "mixed":
            h = _djb2(s) ^ _sdbm(s)
        else:                       # djb2 (default) and built_in
            h = _djb2(s)
        return h % num_servers

    # -- push/pull speed window --------------------------------------------
    def telemetry_record(self, nbytes: int) -> None:
        t = time.monotonic_ns() // 1000
        with self._lock:
            self._tel_events.append((t, nbytes))
            cutoff = t - self._tel_window_us
            self._tel_events = [e for e in self._tel_events if e[0] >= cutoff]

    def telemetry_speed_mbps(self) -> float:
        t = time.monotonic_ns() // 1000
        cutoff = t - self._tel_window_us
        with self._lock:
            total = sum(b for ts, b in self._tel_events if ts >= cutoff)
        return (total / 1e6) / (self._tel_window_us / 1e6)

    # -- trace recorder ----------------------------------------------------
    def trace_enable(self, on: bool) -> None:
        self.trace_on = bool(on)

    @staticmethod
    def trace_now_us() -> int:
        return time.monotonic_ns() // 1000

    def trace_record(self, name: str, stage: str, ts_us: int,
                     dur_us: int) -> None:
        if self.trace_on:
            self._trace_events.append((name, stage, ts_us, dur_us))

    def trace_count(self) -> int:
        return len(self._trace_events)

    def trace_dump(self, path: str, rank: int) -> None:
        """Write the recorded events as a chrome trace and clear them."""
        events = [{"name": n, "cat": "comm", "ph": "X", "ts": ts, "dur": d,
                   "pid": rank, "tid": stage}
                  for (n, stage, ts, d) in self._trace_events]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        self._trace_events.clear()

    # -- handles -----------------------------------------------------------
    def handle_allocate(self) -> int:
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            self._handles[h] = 0
            return h

    def handle_mark_done(self, h: int) -> None:
        with self._lock:
            self._handles[h] = 1

    def handle_poll(self, h: int) -> int:
        with self._lock:
            return self._handles.get(h, -1)

    def handle_release(self, h: int) -> None:
        with self._lock:
            self._handles.pop(h, None)


_core: Optional[Core] = None
_core_lock = threading.Lock()


def get_core() -> Core:
    """The process-wide core."""
    global _core
    with _core_lock:
        if _core is None:
            _core = Core()
        return _core
