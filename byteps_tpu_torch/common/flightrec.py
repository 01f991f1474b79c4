"""Black-box flight recorder + postmortem bundles.

Counterpart of ``byteps_tpu/common/flightrec.py``: a bounded, lock-light
in-memory ring of structured events (init/shutdown, doctor findings,
whatever a plane records), dumped by an atexit/faulthandler hook or on
demand into a self-contained JSON **postmortem bundle**: events + final
metrics snapshot + config + the sections the planes provide (the step
counter, the device plane's ``device`` section, the doctor's
``diagnosis`` and window history).  The bundle schema is the JAX
package's, so ``tools/postmortem.py`` merges and renders the port's
bundles and ``tools/bps_doctor.py`` replays them unchanged.

Cost model: ``record()`` is a dict build + deque append (~µs) and the
ring is bounded (``BYTEPS_TPU_FLIGHTREC_EVENTS``, default 4096; 0
disables recording entirely).  Bundles are written ONLY when
``BYTEPS_TPU_POSTMORTEM_DIR`` names a directory — an unarmed run never
touches the filesystem.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .logging import get_logger

DEFAULT_EVENTS = 4096

BUNDLE_SCHEMA = "bps-postmortem-v1"


class FlightRecorder:
    """Bounded ring of structured events.

    ``record()`` runs on hot-ish paths (per-round markers, transport
    transitions), so it takes one short lock around a deque append —
    no I/O, no formatting; events are rendered only at dump time.
    """

    def __init__(self, capacity: int = DEFAULT_EVENTS):
        self.capacity = max(0, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity or 1)
        self._count = 0
        self._lock = threading.Lock()

    def record(self, kind: str, **fields: Any) -> None:
        if self.capacity <= 0:
            return
        ev = {"t": time.time(), "mono": time.monotonic(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)
            self._count += 1

    def events(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._count - len(self._ring))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._count = 0


_recorder: Optional[FlightRecorder] = None
_rec_lock = threading.Lock()
# Named bundle-section providers ("api" = the api layer's step counter;
# "device" = the device plane; "doctor" = the diagnosis and window
# history) — each runs ONCE per dump, merged in name order.
_providers: Dict[str, Callable[[], dict]] = {}
_armed = False
_fault_file = None          # keeps the faulthandler stream alive
_fault_was_enabled = False  # faulthandler's state before arm_postmortem


def _capacity_from_env() -> int:
    v = os.environ.get("BYTEPS_TPU_FLIGHTREC_EVENTS")
    if v is None or v == "":
        return DEFAULT_EVENTS
    try:
        return max(0, int(v))
    except ValueError:
        get_logger().warning(
            "ignoring invalid BYTEPS_TPU_FLIGHTREC_EVENTS=%r "
            "(want an event count; 0 disables)", v)
        return DEFAULT_EVENTS


def get_recorder() -> FlightRecorder:
    global _recorder
    with _rec_lock:
        if _recorder is None:
            _recorder = FlightRecorder(_capacity_from_env())
        return _recorder


def reset(capacity: Optional[int] = None) -> FlightRecorder:
    """Testing hook: fresh recorder (optionally with an explicit
    capacity, else re-read from the environment)."""
    global _recorder
    with _rec_lock:
        _recorder = FlightRecorder(
            _capacity_from_env() if capacity is None else capacity)
        return _recorder


def record(kind: str, **fields: Any) -> None:
    """Append one structured event to the process-wide flight ring."""
    get_recorder().record(kind, **fields)


def set_extra_provider(fn: Optional[Callable[[], dict]],
                       name: str = "api") -> None:
    """Register a named bundle-section provider (None unregisters).
    Sections are collected best-effort at dump time; a provider must
    not touch the wire — a bundle is written exactly when the wire may
    be the broken part."""
    if fn is None:
        _providers.pop(name, None)
    else:
        _providers[name] = fn


def remove_extra_provider(name: str, owner: Any = None) -> None:
    """Unregister `name` — only if the registered provider is still
    `owner`'s bound method when an owner is given, so a closed owner
    cannot knock out a newer owner's provider (bound methods are
    fresh objects per attribute access, so identity is compared on
    ``__self__``, not the callable)."""
    cur = _providers.get(name)
    if owner is None or getattr(cur, "__self__", None) is owner:
        _providers.pop(name, None)


def postmortem_dir() -> str:
    """Resolved at call time (not import) so tests and late-configured
    jobs can arm bundles without re-importing."""
    return os.environ.get("BYTEPS_TPU_POSTMORTEM_DIR", "")


def _rank() -> int:
    for var in ("BYTEPS_GLOBAL_RANK", "DMLC_WORKER_ID"):
        v = os.environ.get(var)
        if v not in (None, ""):
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _sanitize(obj):
    """Make a metrics/extra tree strict-JSON-safe: histogram +Inf bucket
    bounds (and any other non-finite float) become strings — a bare
    ``Infinity`` in the output would make the bundle unparseable by
    exactly the tool it exists for.  Delegates to the one shared walk
    (telemetry.json_safe, also behind the /signals and /diagnosis
    routes) so bundles and routes can never encode the same value
    differently."""
    from .telemetry import json_safe
    return json_safe(obj)


def dump_bundle(reason: str, extra: Optional[dict] = None,
                directory: Optional[str] = None) -> Optional[str]:
    """Write one self-contained postmortem bundle; returns its path, or
    None when bundles are unarmed (no ``BYTEPS_TPU_POSTMORTEM_DIR``).
    Never raises — the dump path runs inside failure handlers."""
    try:
        d = directory if directory is not None else postmortem_dir()
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        rec = get_recorder()
        rank = _rank()
        doc: Dict[str, Any] = {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "rank": rank,
            "host": socket.gethostname(),
            "pid": os.getpid(),
            # The wall/mono pair anchors this process's monotonic event
            # timestamps onto the wall clock, which is what
            # tools/postmortem.py aligns bundles from different workers
            # by (each event also carries its own wall time).
            "clock": {"wall": time.time(), "mono": time.monotonic()},
            "config": {k: v for k, v in sorted(os.environ.items())
                       if k.startswith(("BYTEPS", "DMLC"))},
            "events_dropped": rec.dropped,
            "events": rec.events(),
        }
        try:
            from . import telemetry
            doc["metrics"] = telemetry.get_registry().snapshot()
        except Exception:
            doc["metrics"] = {}
        sections: Dict[str, Any] = {}
        for pname in sorted(_providers):
            fn = _providers.get(pname)
            if fn is None:
                continue
            try:
                sections.update(fn() or {})
            except Exception:
                get_logger().debug("postmortem provider %r failed",
                                   pname, exc_info=True)
        if extra:
            sections.update(extra)
        doc["extra"] = sections
        name = (f"bps-postmortem-r{rank}-{reason}-"
                f"{os.getpid()}-{int(time.time() * 1000)}.json")
        path = os.path.join(d, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_sanitize(doc), f)
        os.replace(tmp, path)
        get_logger().error(
            "postmortem bundle written: %s (reason=%s, %d events; render "
            "with: python tools/postmortem.py %s)", path, reason,
            len(doc["events"]), d)
        return path
    except Exception:
        get_logger().exception("postmortem bundle dump failed")
        return None


def arm_postmortem(directory: Optional[str] = None) -> bool:
    """Idempotently arm the crash hooks: an atexit bundle (a run that
    dies mid-flight still leaves its black box behind) and a
    ``faulthandler`` traceback file next to the bundles for fatal
    signals (SIGSEGV/SIGABRT — states Python-level hooks never see).
    Returns True when armed (a directory is configured)."""
    global _armed, _fault_file, _fault_was_enabled
    d = directory if directory is not None else postmortem_dir()
    if not d or _armed:
        return _armed
    try:
        os.makedirs(d, exist_ok=True)
        import atexit
        atexit.register(_dump_on_exit)
        try:
            import faulthandler
            _fault_was_enabled = faulthandler.is_enabled()
            _fault_file = open(
                os.path.join(d, f"bps-faulthandler-r{_rank()}-"
                                f"{os.getpid()}.log"), "w")
            faulthandler.enable(file=_fault_file)
        except Exception:
            get_logger().debug("faulthandler arm failed", exc_info=True)
        _armed = True
        get_logger().info(
            "flight recorder armed: postmortem bundles -> %s", d)
    except Exception:
        get_logger().exception("postmortem arm failed")
    return _armed


def _dump_on_exit() -> None:
    try:
        record("exit")
        dump_bundle("exit")
    except Exception:
        pass


def disarm_postmortem() -> None:
    """Undo ``arm_postmortem``: drop the atexit bundle and close the
    faulthandler file (tests and scripts that armed bundles into a
    directory they delete afterwards)."""
    global _armed, _fault_file
    if not _armed:
        return
    import atexit
    import faulthandler
    import sys
    atexit.unregister(_dump_on_exit)
    faulthandler.disable()
    if _fault_was_enabled:
        faulthandler.enable(file=sys.stderr)
    if _fault_file is not None:
        _fault_file.close()
        _fault_file = None
    _armed = False
