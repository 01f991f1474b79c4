"""The host core: tensor registry, keys, partitions, placement hashes,
the scheduled queue, async handles, the push/pull speed window and the
trace recorder, in two twins held equal method by method.

  - ``_CCore`` is the ctypes face of ``libbyteps_core`` built from
    ``core.cc`` and ``server.cc`` beside this file, byte-identical copies
    of the JAX package's (``build.py``); ``NativeQueue`` is its
    ScheduledQueue.  ``get_native_core()`` builds the library at its first
    use and returns the process's ``_CCore``; where it cannot build, it
    raises with the compiler's output (no fallback).  ``is_native()`` says
    whether this process has loaded it.
  - ``Core`` is the pure-Python twin (the reference's ``_PyCore``), with
    ``_PyQueue`` as its queue.  ``get_core()`` returns the process's
    ``Core``.

The selection law: the eager data-parallel path (``common/api.py``) runs
on ``get_core()``, the Python twin; the parameter-server tier loads
``get_native_core()``, whose library also carries the PS server, the
wire codec and the ring.

  - Declared names get dense keys 0, 1, 2, ... in declaration order; the
    registry survives ``suspend``/``resume``, so keys stay stable.
  - Partition ``p`` of declared key ``k`` travels as ``k << 16 | p``
    (core.cc ``bps_encode_key``); ``partition_bounds`` cuts a tensor's
    bytes into pieces of at most ``partition_bytes`` (core.cc:134).
  - ``key_to_server`` places a key on a server with the hashes of
    core.cc:149-181: djb2 (and ``built_in``), sdbm, ``mixed`` (their XOR)
    over the key's decimal digits, or ``naive`` (the key itself).
  - A queue hands out tasks by (priority desc, key asc); with a credit,
    only tasks that fit the bytes not yet reported finished.
  - Handles are allocated 0, 1, 2, ...; ``handle_poll`` is -1 for a handle
    never allocated or already released, 0 while pending, 1 when done.
"""

from __future__ import annotations

import ctypes
import json
import threading
import time
from typing import List, Optional, Tuple

from ..common.logging import get_logger

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


class _CCore:
    """ctypes face of libbyteps_core."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        # Python-side mirror of the native tracer's on/off flag: hot paths
        # read this attribute instead of crossing into C per partition.
        self.trace_on = False
        L = lib
        L.bps_declare_tensor.argtypes = [ctypes.c_char_p]
        L.bps_declare_tensor.restype = ctypes.c_int32
        L.bps_get_declared_key.argtypes = [ctypes.c_char_p]
        L.bps_get_declared_key.restype = ctypes.c_int32
        L.bps_num_declared.restype = ctypes.c_int32
        L.bps_declared_name.argtypes = [ctypes.c_int32, ctypes.c_char_p,
                                        ctypes.c_int32]
        L.bps_declared_name.restype = ctypes.c_int32
        L.bps_reset_registry.restype = None
        L.bps_encode_key.argtypes = [ctypes.c_int32, ctypes.c_int32]
        L.bps_encode_key.restype = ctypes.c_uint64
        L.bps_decode_declared_key.argtypes = [ctypes.c_uint64]
        L.bps_decode_declared_key.restype = ctypes.c_int32
        L.bps_decode_part_idx.argtypes = [ctypes.c_uint64]
        L.bps_decode_part_idx.restype = ctypes.c_int32
        L.bps_align.argtypes = [ctypes.c_int64, ctypes.c_int64]
        L.bps_align.restype = ctypes.c_int64
        L.bps_partition_count.argtypes = [ctypes.c_int64, ctypes.c_int64]
        L.bps_partition_count.restype = ctypes.c_int32
        L.bps_partition_bounds.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        L.bps_partition_bounds.restype = ctypes.c_int32
        L.bps_key_to_server.argtypes = [ctypes.c_uint64, ctypes.c_int32,
                                        ctypes.c_char_p]
        L.bps_key_to_server.restype = ctypes.c_int32
        L.bps_queue_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
        L.bps_queue_create.restype = ctypes.c_void_p
        L.bps_queue_destroy.argtypes = [ctypes.c_void_p]
        L.bps_queue_add.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_int32, ctypes.c_int64]
        L.bps_queue_get.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint64),
                                    ctypes.POINTER(ctypes.c_int32)]
        L.bps_queue_get.restype = ctypes.c_int64
        L.bps_queue_get_key.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        L.bps_queue_get_key.restype = ctypes.c_int64
        L.bps_queue_report_finish.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        L.bps_queue_pending.argtypes = [ctypes.c_void_p]
        L.bps_queue_pending.restype = ctypes.c_int64
        L.bps_telemetry_set_window_us.argtypes = [ctypes.c_int64]
        L.bps_telemetry_record.argtypes = [ctypes.c_int64]
        L.bps_telemetry_speed_mbps.restype = ctypes.c_double
        L.bps_trace_enable.argtypes = [ctypes.c_int32]
        L.bps_trace_now_us.restype = ctypes.c_int64
        L.bps_trace_record.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int64, ctypes.c_int64]
        L.bps_trace_record_part.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
        L.bps_trace_count.restype = ctypes.c_int64
        L.bps_trace_dump.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        L.bps_trace_dump.restype = ctypes.c_int32
        L.bps_handle_allocate.restype = ctypes.c_int32
        L.bps_handle_mark_done.argtypes = [ctypes.c_int32]
        L.bps_handle_poll.argtypes = [ctypes.c_int32]
        L.bps_handle_poll.restype = ctypes.c_int32
        L.bps_handle_release.argtypes = [ctypes.c_int32]
        L.bps_ring_owner.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32,
            ctypes.c_int32]
        L.bps_ring_owner.restype = ctypes.c_int64

    # -- registry --
    def declare_tensor(self, name: str) -> int:
        return self._lib.bps_declare_tensor(name.encode())

    def get_declared_key(self, name: str) -> int:
        return self._lib.bps_get_declared_key(name.encode())

    def num_declared(self) -> int:
        return self._lib.bps_num_declared()

    def declared_name(self, idx: int) -> Optional[str]:
        buf = ctypes.create_string_buffer(1024)
        n = self._lib.bps_declared_name(idx, buf, 1024)
        return None if n < 0 else buf.value.decode()

    def reset_registry(self) -> None:
        self._lib.bps_reset_registry()

    # -- keys / partitioning --
    def encode_key(self, declared_key: int, part_idx: int) -> int:
        return self._lib.bps_encode_key(declared_key, part_idx)

    def decode_key(self, key: int) -> Tuple[int, int]:
        return (self._lib.bps_decode_declared_key(key),
                self._lib.bps_decode_part_idx(key))

    def partition_bounds(self, nbytes: int,
                         partition_bytes: int) -> List[Tuple[int, int]]:
        n = self._lib.bps_partition_count(nbytes, partition_bytes)
        offs = (ctypes.c_int64 * n)()
        lens = (ctypes.c_int64 * n)()
        self._lib.bps_partition_bounds(nbytes, partition_bytes, offs, lens)
        return [(offs[i], lens[i]) for i in range(n)]

    def key_to_server(self, key: int, num_servers: int,
                      hash_fn: str = "djb2") -> int:
        return self._lib.bps_key_to_server(key, num_servers, hash_fn.encode())

    def ring_owner(self, key: int, server_ids, vnodes: int) -> int:
        """The server owning ``key`` on the consistent-hash ring of
        ``server_ids`` (server.cc ``ring::Owner``); -1 for no members."""
        ids = list(server_ids)
        arr = (ctypes.c_uint32 * len(ids))(*ids) if ids else None
        return self._lib.bps_ring_owner(key, arr, len(ids), vnodes)

    # -- scheduled queue --
    def queue_create(self, credit_bytes: int = 0) -> "NativeQueue":
        return NativeQueue(self._lib, credit_bytes)

    # -- telemetry --
    def telemetry_record(self, nbytes: int) -> None:
        self._lib.bps_telemetry_record(nbytes)

    def telemetry_speed_mbps(self) -> float:
        return self._lib.bps_telemetry_speed_mbps()

    def telemetry_set_window_us(self, us: int) -> None:
        self._lib.bps_telemetry_set_window_us(us)

    def telemetry_reset(self) -> None:
        self._lib.bps_telemetry_reset()

    # -- tracing --
    def trace_enable(self, on: bool) -> None:
        self.trace_on = bool(on)
        self._lib.bps_trace_enable(1 if on else 0)

    def trace_now_us(self) -> int:
        return self._lib.bps_trace_now_us()

    def trace_record(self, name: str, stage: str, ts_us: int,
                     dur_us: int) -> None:
        self._lib.bps_trace_record(name.encode(), stage.encode(), ts_us,
                                   dur_us)

    def trace_record_part(self, name: str, stage: str, ts_us: int,
                          dur_us: int, key: int, nbytes: int,
                          priority: int) -> None:
        """Per-partition span (QUEUE/PUSH/PULL) with key, bytes and
        priority args."""
        self._lib.bps_trace_record_part(name.encode(), stage.encode(), ts_us,
                                        dur_us, key, nbytes, priority)

    def trace_count(self) -> int:
        return self._lib.bps_trace_count()

    def trace_dump(self, path: str, rank: int) -> int:
        return self._lib.bps_trace_dump(path.encode(), rank)

    # -- handles --
    def handle_allocate(self) -> int:
        return self._lib.bps_handle_allocate()

    def handle_mark_done(self, h: int) -> None:
        self._lib.bps_handle_mark_done(h)

    def handle_poll(self, h: int) -> int:
        return self._lib.bps_handle_poll(h)

    def handle_release(self, h: int) -> None:
        self._lib.bps_handle_release(h)


class NativeQueue:
    """Priority ScheduledQueue handle (native)."""

    def __init__(self, lib: ctypes.CDLL, credit_bytes: int):
        self._lib = lib
        self._q = lib.bps_queue_create(1 if credit_bytes > 0 else 0,
                                       credit_bytes)

    def add(self, key: int, priority: int, nbytes: int) -> None:
        self._lib.bps_queue_add(self._q, key, priority, nbytes)

    def get(self) -> Optional[Tuple[int, int, int]]:
        """Returns (key, priority, nbytes) or None."""
        k = ctypes.c_uint64()
        p = ctypes.c_int32()
        n = self._lib.bps_queue_get(self._q, ctypes.byref(k), ctypes.byref(p))
        return None if n < 0 else (k.value, p.value, n)

    def get_key(self, key: int) -> Optional[int]:
        n = self._lib.bps_queue_get_key(self._q, key)
        return None if n < 0 else n

    def report_finish(self, nbytes: int) -> None:
        self._lib.bps_queue_report_finish(self._q, nbytes)

    def pending(self) -> int:
        return self._lib.bps_queue_pending(self._q)

    def __del__(self):
        try:
            self._lib.bps_queue_destroy(self._q)
        except Exception:
            pass


class _PyQueue:
    """The Python twin of ``NativeQueue``."""

    def __init__(self, credit_bytes: int = 0):
        self._tasks: list = []
        self._credit_enabled = credit_bytes > 0
        self._credit = credit_bytes
        self._lock = threading.Lock()

    def add(self, key, priority, nbytes):
        with self._lock:
            self._tasks.append((key, priority, nbytes))
            self._tasks.sort(key=lambda t: (-t[1], t[0]))

    def get(self):
        with self._lock:
            for i, (k, p, n) in enumerate(self._tasks):
                if self._credit_enabled and n > self._credit:
                    continue
                self._tasks.pop(i)
                if self._credit_enabled:
                    self._credit -= n
                return (k, p, n)
            return None

    def get_key(self, key):
        with self._lock:
            for i, (k, p, n) in enumerate(self._tasks):
                if k == key:
                    # Same eligibility check as get(): an oversized task
                    # stays queued instead of driving the credit negative.
                    if self._credit_enabled and n > self._credit:
                        return None
                    self._tasks.pop(i)
                    if self._credit_enabled:
                        self._credit -= n
                    return n
            return None

    def report_finish(self, nbytes):
        with self._lock:
            if self._credit_enabled:
                self._credit += nbytes

    def pending(self):
        with self._lock:
            return len(self._tasks)


class Core:
    """The pure-Python twin of ``_CCore``."""

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

    # -- scheduled queue ---------------------------------------------------
    @staticmethod
    def queue_create(credit_bytes: int = 0) -> _PyQueue:
        return _PyQueue(credit_bytes)

    # -- push/pull speed window --------------------------------------------
    def telemetry_set_window_us(self, us: int) -> None:
        self._tel_window_us = us

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

    def telemetry_reset(self) -> None:
        with self._lock:
            self._tel_events.clear()

    # -- trace recorder ----------------------------------------------------
    def trace_enable(self, on: bool) -> None:
        self.trace_on = bool(on)

    @staticmethod
    def trace_now_us() -> int:
        return time.monotonic_ns() // 1000

    def trace_record(self, name: str, stage: str, ts_us: int,
                     dur_us: int) -> None:
        if self.trace_on:
            self._trace_events.append((name, stage, ts_us, dur_us, None))

    def trace_record_part(self, name: str, stage: str, ts_us: int,
                          dur_us: int, key: int, nbytes: int,
                          priority: int) -> None:
        """Per-partition span (QUEUE/PUSH/PULL) with key, bytes and
        priority args."""
        if self.trace_on:
            self._trace_events.append(
                (name, stage, ts_us, dur_us,
                 {"key": key, "bytes": nbytes, "priority": priority}))

    def trace_count(self) -> int:
        return len(self._trace_events)

    def trace_dump(self, path: str, rank: int) -> int:
        """Write the recorded events as a chrome trace, clear them, and
        return 0 (the native dump's success code)."""
        events = [{"name": n, "cat": "comm", "ph": "X", "ts": ts, "dur": d,
                   "pid": rank, "tid": stage,
                   **({"args": args} if args else {})}
                  for (n, stage, ts, d, args) in self._trace_events]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        self._trace_events.clear()
        return 0

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
_native: Optional[_CCore] = None
_core_lock = threading.Lock()


def get_core() -> Core:
    """The process-wide Python core, which the eager data-parallel path
    runs on.

    It stays the Python twin, not the native core: the twins are held
    equal method by method (``tests/test_torch_port_native.py``), so no
    result depends on the choice, while loading the native core would
    make every process that touches a key compile the C++ core (seconds
    to tens of seconds) or wait on another process compiling it.  The PS
    tier selects ``get_native_core()``."""
    global _core
    with _core_lock:
        if _core is None:
            _core = Core()
        return _core


def get_native_core() -> _CCore:
    """The process-wide native core, built at first use (``build.py``).
    Raises RuntimeError with the compiler's output where it cannot build;
    there is no fallback."""
    global _native
    with _core_lock:
        if _native is None:
            from . import build
            path = build.build()
            _native = _CCore(ctypes.CDLL(path))
            get_logger().debug("loaded native core from %s", path)
        return _native


def is_native() -> bool:
    """Whether this process has loaded the native core (never builds)."""
    return _native is not None
