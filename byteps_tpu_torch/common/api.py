"""The user API over ``torch.distributed``: lifecycle, topology, the eager
push_pull family, broadcasts and the step counter.

Counterpart of ``byteps_tpu/common/api.py``.  A world of one needs no
process group: every collective is then the identity.  With
``DMLC_NUM_WORKER > 1``, ``init()`` joins the process group at
``tcp://DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT`` as rank ``DMLC_WORKER_ID`` —
NCCL when CUDA is present, gloo otherwise.  A caller that set up the
process group itself may call ``init()`` all the same: it joins nothing.

The eager path (``push_pull``, ``push_pull_async`` + ``synchronize`` /
``poll``, ``push_pull_tree``) is for out-of-graph tensors — metric
averages, parameter broadcasts, the Horovod plugin's gradients — as in the
JAX package: each named tensor gets a declared key (``core.native``), each
call a handle, and ``push_pull_tree`` packs small leaves into the fusion
planner's buckets (``common.fusion.plan_buckets``), dispatched in
priority order as concurrent async all-reduces.  Tensors stay on their
device.  ``priority`` orders the dispatch of a tree's units; the process
group runs collectives in issue order.

PS mode (``BYTEPS_TPU_PS_MODE=1``) reduces through the PS servers
instead, as the JAX package's does: ``init()`` opens a
``server.client.PSSession`` from the configuration and meets the other
workers at its barrier, and opens no process group.  The eager path then
stages each tensor into a float32 host buffer (pinned for a CUDA tensor,
one set per declared key, reused once its round has completed) and hands
the session that buffer; the pulled float32 sum is cast back to the
pushed dtype on the tensor's device, decompressed, then averaged there,
in the JAX package's order.  ``rank()`` is
``DMLC_WORKER_ID`` and ``size()`` follows the membership epoch.  In PS
mode the API runs on the native core, the session's own (its keys, trace
switch and spans); elsewhere on the Python twin.  There is no fallback:
an unreachable server or a library that does not build raises.

``BYTEPS_DEBUG_SAMPLE_TENSOR`` writes a sample of every eager tensor whose
name contains it to stderr, at push entry and after synchronize.

``init()`` arms the worker-local observability planes as the JAX
package's does: the flight recorder (postmortem bundles with
``BYTEPS_TPU_POSTMORTEM_DIR``), the device plane (``BYTEPS_TPU_DEVPROF``),
the signal plane and doctor (``BYTEPS_TPU_SIGNAL_WINDOW_S`` > 0) and the
metrics exporter (``BYTEPS_TPU_METRICS_PORT``, ``BYTEPS_TPU_METRICS_LOG``,
serving ``/metrics``, ``/signals``, ``/diagnosis`` and ``/device``);
``shutdown()`` closes the last window, stops the exporter, dumps the
trace with its device lane and disarms.  ``get_metrics``,
``get_key_signals``, ``get_diagnosis`` and ``get_device_profile`` read
them.

``BYTEPS_ENABLE_ASYNC`` is the servers' mode: the workers' side of it is
``parallel.async_ps.AsyncPSTrainer`` and the Horovod face's
``enable_async``.  ``push_pull_sparse`` reaches a server-resident
embedding table (``parallel.embedding.EmbeddingTable`` shards one).  The
hierarchical reduction (``BYTEPS_TPU_HIERARCHY`` in PS mode,
``get_hierarchy``) and the fleet-level planes (fleet, tuner, autoscaler)
are not ported: they raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

import numpy as np

from ..core.native import get_core, get_native_core
from . import devprof, flightrec, signals, telemetry, trace_analysis
from . import doctor as doctor_mod
from .config import Config, get_config
from .logging import get_logger, set_level, set_rank
from .tree import tree_leaves, tree_paths, tree_unflatten

Tree = Any


@dataclasses.dataclass
class _State:
    initialized: bool = False
    config: Optional[Config] = None
    step: int = 0
    step_start_us: Optional[int] = None
    # handle -> (buffer, pending work or None, compression, ctx, average,
    #            name, t0)
    handles: Dict[int, Any] = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    exporter: Optional[Any] = None    # TelemetryExporter, when enabled
    # Windowed key-signal plane + doctor (BYTEPS_TPU_SIGNAL_WINDOW_S > 0):
    # the final verdict is emitted exactly once (shutdown or the atexit
    # guard, whichever runs first).
    signal_plane: Optional[Any] = None
    doctor: Optional[Any] = None
    doctor_verdict_done: bool = False
    doctor_atexit: bool = False
    trace_atexit: bool = False        # crash-flush guard registered
    ps_session: Optional[Any] = None  # PS-mode client session, when enabled
    # Elastic membership: the last fetched view (size() reads it), the
    # registered callback and the poller plumbing.
    membership: Optional[dict] = None
    membership_cb: Optional[Any] = None
    membership_poll_stop: Optional[Any] = None
    membership_poll_thread: Optional[Any] = None
    membership_poll_interval: float = 2.0
    # PS staging: declared key -> free float32 host buffers (pinned for
    # CUDA tensors).  A buffer leaves the list while a round reads it.
    stage_free: Dict[int, list] = dataclasses.field(default_factory=dict)
    staging: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(_STAGING_ZERO))


_STAGING_ZERO = {"to_host_ms": 0.0, "to_device_ms": 0.0,
                 "to_host_bytes": 0, "to_device_bytes": 0, "copies": 0}

_state = _State()


def _require_init() -> None:
    if not _state.initialized:
        raise RuntimeError(
            "byteps_tpu_torch not initialized; call bps.init() first")


def _not_ported(name: str, item: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to byteps_tpu_torch yet (ROADMAP.md "
            f"Queue 1 item {item})")
    stub.__name__ = name
    stub.__doc__ = f"Not ported yet: ROADMAP.md Queue 1 item {item}."
    return stub


# ---------------------------------------------------------------------------
# Lifecycle and topology
# ---------------------------------------------------------------------------
def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _core():
    """The core the API runs on: the native one in PS mode (the
    session's own, so that the keys, the trace switch the traced-round
    wire flag follows and the spans are one), the Python twin
    otherwise."""
    return get_native_core() if _state.ps_session is not None \
        else get_core()


def init() -> None:
    """Initialize: join the process group (``DMLC_NUM_WORKER`` > 1) or,
    with ``BYTEPS_TPU_PS_MODE=1``, open the PS session and meet the other
    workers at its barrier."""
    if _state.initialized and _state.ps_session is not None:
        return
    cfg = get_config(refresh=True)
    if cfg.hierarchy and cfg.ps_mode:
        raise NotImplementedError(
            "BYTEPS_TPU_HIERARCHY (hierarchical reduction over the PS tier) "
            "is not ported to byteps_tpu_torch yet (ROADMAP.md Queue 1 "
            "item 6c)")
    if cfg.hierarchy:
        get_logger().warning(
            "BYTEPS_TPU_HIERARCHY=1 outside PS mode is a no-op: the knob "
            "arms the PS tier's leader-aware push_pull only")
    set_level(cfg.log_level)
    _state.config = cfg
    if cfg.ps_mode and cfg.role == "worker":
        _open_ps_session(cfg)
    elif cfg.num_worker > 1 and not is_distributed():
        if torch.cuda.is_available():
            torch.cuda.set_device(cfg.local_rank)
        dist.init_process_group(
            backend="nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{cfg.scheduler_uri}:{cfg.scheduler_port}",
            world_size=cfg.num_worker, rank=cfg.worker_id)
    _state.initialized = True
    _core().trace_enable(cfg.trace_on and cfg.trace_start_step
                         <= _state.step <= cfg.trace_end_step)
    if cfg.trace_on and not _state.trace_atexit:
        # Crash flush: a run that dies mid-window (an exception, a failed
        # watchdog) still leaves comm.json; after a clean shutdown() the
        # tracer is empty and the guard writes nothing.
        import atexit
        atexit.register(_dump_trace_on_exit)
        _state.trace_atexit = True
    set_rank(rank() if size() > 1 else None)
    _arm_planes(cfg)
    get_logger().info("byteps_tpu_torch initialized: rank=%d/%d "
                      "local_rank=%d ps_mode=%s", rank(), size(),
                      local_rank(), _state.ps_session is not None)


def _open_ps_session(cfg: Config) -> None:
    """PS mode: the native core (built here at first use; raises where it
    cannot build), the Python twin's names replayed into it in order so
    that keys declared before init() keep their values, then the session,
    its startup barrier, the membership poller
    (``BYTEPS_TPU_EVICT_TIMEOUT_S`` > 0) and, when tracing, the servers'
    clock sync."""
    from ..server.client import PSSession
    core = get_native_core()
    _state.staging = dict(_STAGING_ZERO)
    twin = get_core()
    for i in range(twin.num_declared()):
        name = twin.declared_name(i)
        if name is not None:
            core.declare_tensor(name)
    sess = PSSession.from_config(cfg)
    try:
        sess.barrier()
    except BaseException:
        sess.close()
        raise
    _state.ps_session = sess
    if cfg.evict_timeout_s > 0:
        # size() and the averages must follow an eviction even when the
        # application registers no callback.
        _start_membership_poller(cfg.membership_poll_s)
    if cfg.trace_on:
        try:
            sess.sync_clocks()
            sess.start_clock_sync()
        except Exception as e:
            get_logger().warning(
                "server clock sync unavailable (%s); trace will carry "
                "worker spans only", e)


def _arm_planes(cfg: Config) -> None:
    """The worker-local observability planes, armed as the JAX package's
    ``init()`` arms them outside PS mode."""
    # Black-box flight recorder: lifecycle events always record (bounded
    # in-memory ring, no I/O); postmortem bundles + the faulthandler
    # crash file arm only when BYTEPS_TPU_POSTMORTEM_DIR is set.
    flightrec.set_extra_provider(_postmortem_extra)
    flightrec.record("init", role=cfg.role, rank=rank(), size=size())
    if cfg.postmortem_dir:
        flightrec.arm_postmortem(cfg.postmortem_dir)
    _register_builtin_collectors()
    if cfg.devprof:
        # Device plane: arm the profiler, run the init-time sentinel
        # probe (the re-probe rides every window roll), and hand the
        # flight recorder its `device` bundle section.  Off (default):
        # none of this exists — zero gauges, the trainer hooks a None
        # check.
        prof = devprof.arm(intended_platform=cfg.device_platform,
                           worker=rank(), telemetry_on=cfg.telemetry_on)
        probe = prof.probe()
        if probe.get("fallback"):
            get_logger().error(
                "device sentinel convicted a fallback at init: %s",
                probe.get("reason"))
        flightrec.set_extra_provider(prof.flight_section, name="device")
    # One knob, one meaning: the plane arms iff SIGNAL_WINDOW_S > 0.
    if cfg.signal_window_s > 0:
        _start_signal_plane(cfg)
    if _state.exporter is not None:       # init() again without shutdown()
        _state.exporter.stop()
        _state.exporter = None
    if cfg.metrics_port > 0 or cfg.metrics_log:
        try:
            _state.exporter = telemetry.TelemetryExporter(
                telemetry.get_registry(), port=cfg.metrics_port,
                jsonl_path=cfg.metrics_log,
                max_log_mb=cfg.metrics_log_mb,
                refresh=_refresh_server_metrics,
                routes=_signal_routes()).start()
        except OSError as e:
            # A taken port / unwritable log path must not kill training —
            # the metrics plane is an observer, never a dependency.
            get_logger().error(
                "metrics exporter failed to start "
                "(BYTEPS_TPU_METRICS_PORT=%d, BYTEPS_TPU_METRICS_LOG=%r): "
                "%s — continuing without it", cfg.metrics_port,
                cfg.metrics_log, e)
            _state.exporter = None


def shutdown() -> None:
    """Leave the process group or close the PS session; the declared-name
    registry stays, so keys are the same after ``resume``.  Closes the
    signal plane's last window and logs the doctor's verdict, stops the
    exporter, dumps the trace (with its device lane and the servers'
    spans: a run that never reached its trace end step still gets one)
    and disarms the device plane, its bundle section frozen to the final
    snapshot."""
    if _state.initialized:
        flightrec.record("shutdown", step=_state.step)
    if _state.membership_poll_stop is not None:
        _state.membership_poll_stop.set()
    _state.membership_poll_stop = None
    _state.membership_poll_thread = None
    _state.membership_cb = None
    _state.membership = None
    _stop_signal_plane()
    if _state.exporter is not None:
        _state.exporter.stop()
        _state.exporter = None
    _maybe_dump_trace()
    prof = devprof.active()
    if prof is not None:
        # Bundles dumped after shutdown (the atexit one) still answer
        # "was it on-chip?".
        snap = prof.flight_section()
        flightrec.set_extra_provider(lambda: snap, name="device")
        devprof.disarm()
    if _state.ps_session is not None:
        _state.ps_session.close()
        _state.ps_session = None
    elif is_distributed():
        dist.destroy_process_group()
    set_rank(None)
    with _state.lock:
        _state.handles.clear()
        _state.stage_free.clear()
    _state.initialized = False


def suspend() -> None:
    """Elastic suspend: tear down communication, keep the registry."""
    shutdown()


def resume(num_workers: int, num_servers: int = 0) -> None:
    """Elastic resume with a new cluster size: re-read the environment,
    rejoin, and re-declare every name in its original order, so the keys
    are unchanged.  Tensors cross the resize as they are (they live on
    their device, not in the process group)."""
    if _state.initialized:
        suspend()
    os.environ["DMLC_NUM_WORKER"] = str(num_workers)
    os.environ["DMLC_NUM_SERVER"] = str(num_servers)
    core = _core()
    names = [core.declared_name(i) for i in range(core.num_declared())]
    init()
    for n in names:
        if n is not None:
            declare(n)


def process_rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if is_distributed() else 0


def rank() -> int:
    """The worker's rank: the ``BYTEPS_GLOBAL_RANK`` override first, as in
    the JAX package, then ``DMLC_WORKER_ID`` in PS mode, else the process
    group's rank."""
    cfg = _state.config or get_config()
    if cfg.global_rank is not None:
        return cfg.global_rank
    if _state.ps_session is not None:
        return cfg.worker_id
    return process_rank()


def size() -> int:
    """The number of workers.  In PS mode, once the membership epoch has
    ever advanced, the live worker set of the cached view (refreshed by
    ``get_membership()`` and the poller); until then the launch count."""
    if _state.ps_session is not None:
        m = _state.membership
        if m is not None and int(m.get("epoch", 0)) > 0:
            return max(1, len(m.get("alive", ())))
        return (_state.config or get_config()).num_worker
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    return (_state.config or get_config()).local_rank


def local_size() -> int:
    return (_state.config or get_config()).local_size


# ---------------------------------------------------------------------------
# Declaration and keys
# ---------------------------------------------------------------------------
def declare(name: str) -> int:
    """Assign (or look up) the deterministic key of a named tensor.  In
    PS mode the native core assigns it and the Python twin follows, so
    that the two registries stay one."""
    if _state.ps_session is not None:
        key = get_native_core().declare_tensor(name)
        get_core().declare_tensor(name)
        return key
    return get_core().declare_tensor(name)


def _session_declare(name: str) -> int:
    """The key of ``name`` on the PS client's core, for the PS trainers:
    through ``declare`` when the API runs in PS mode (both registries stay
    one), else the native core's own, on which a session opened by hand
    encodes its keys."""
    if _state.ps_session is not None:
        return declare(name)
    return get_native_core().declare_tensor(name)


def declared_key(name: str) -> int:
    return _core().get_declared_key(name)


def register_compressor(name: str, kwargs: dict) -> int:
    """Register PS-wire compression for a named tensor: the kwargs use the
    reference registry's strings (``{"compressor": "onebit", ...}``) and
    ride the tensor's INIT, so the server decompresses, sums and
    recompresses.  Returns the declared key.  Outside PS mode, as in the
    JAX package, this only declares (the collective plane compresses
    through ``DistributedOptimizer``)."""
    _require_init()
    dk = declare(name)
    if _state.ps_session is not None:
        _state.ps_session.register_compressor(dk, kwargs)
    return dk


def get_ps_session():
    """The live PS-mode session, or None (collective mode)."""
    return _state.ps_session


# ---------------------------------------------------------------------------
# Elastic membership and the server ring (PS mode)
# ---------------------------------------------------------------------------
def leave(drain_timeout_s: float = 60.0) -> None:
    """Gracefully exit the worker membership (PS mode): drain this
    worker's in-flight rounds, then leave every server's membership at
    the next epoch boundary; the survivors' open rounds re-finalize
    without it.  A no-op with a warning outside PS mode."""
    _require_init()
    if _state.ps_session is None:
        get_logger().warning(
            "bps.leave() outside PS mode is a no-op: collective-plane "
            "resizes go through suspend()/resume()")
        return
    _state.ps_session.leave(drain_timeout_s)


def get_ring() -> dict:
    """The elastic PS server ring (CMD_RING): epoch, vnodes, member rows,
    per-server keys owned and draining flags.  A fixed single-epoch view
    without the armed ring (``BYTEPS_TPU_RING=1``) or outside PS mode."""
    _require_init()
    sess = _state.ps_session
    if sess is None or not getattr(sess, "ring_armed", False):
        cfg = _state.config or get_config()
        n = max(1, cfg.num_server) if sess is not None else 0
        return {"epoch": 0, "armed": 0, "vnodes": cfg.ring_vnodes,
                "servers": [{"id": i} for i in range(n)]}
    return sess.get_ring()


def drain_ps_server(server_id: int, timeout_s: float = 120.0,
                    shutdown: bool = False) -> dict:
    """Scale the PS tier down by one server (CMD_DRAIN): its keys' state
    streams to their new ring owners, sums exact across the boundary.
    Blocks until the target owns no key; ``shutdown=True`` also retires
    the process.  PS mode with the ring armed, from one worker."""
    _require_init()
    if _state.ps_session is None:
        raise RuntimeError(
            "bps.drain_ps_server() requires PS mode (BYTEPS_TPU_PS_MODE=1)")
    return _state.ps_session.drain_server(server_id, timeout_s=timeout_s,
                                          shutdown=shutdown)


def get_membership(refresh: bool = True) -> dict:
    """The worker membership: ``{"epoch", "workers": {id: {"alive",
    "age_ms"}}, "alive": [ids], "barrier": {...}}``, fetched from the
    servers in PS mode (``refresh=False``: the cached view), else the
    fixed launch world.  Fetches feed the membership gauges."""
    _require_init()
    if _state.ps_session is not None and refresh:
        m = _state.ps_session.membership()
        _state.membership = m
        telemetry.update_membership(m)
        return m
    if _state.membership is not None:
        return _state.membership
    n = size()
    return {"epoch": 0,
            "workers": {i: {"alive": True, "age_ms": 0.0}
                        for i in range(n)},
            "alive": list(range(n)), "barrier": {}}


def _start_membership_poller(interval: float) -> None:
    """Idempotently start the CMD_MEMBERS poller: refresh the cached view
    (what size() reads) and the gauges every ``interval`` seconds, and
    fire the registered callback on each epoch change.  A later call
    retunes the live poller's interval."""
    _state.membership_poll_interval = max(0.05, float(interval))
    if _state.membership_poll_thread is not None:
        return
    stop = threading.Event()
    _state.membership_poll_stop = stop

    def _poll():
        last_epoch = (int(_state.membership.get("epoch", 0))
                      if _state.membership else 0)
        while not stop.wait(_state.membership_poll_interval):
            sess = _state.ps_session
            if sess is None:
                return
            try:
                m = sess.membership(timeout=5.0)
            except Exception as e:
                get_logger().debug("membership poll failed: %s", e)
                continue
            _state.membership = m       # size() follows before the cb runs
            telemetry.update_membership(m)
            if int(m.get("epoch", 0)) != last_epoch:
                last_epoch = int(m.get("epoch", 0))
                flightrec.record("membership_epoch", epoch=last_epoch,
                                 alive=list(m.get("alive", ())))
                cb = _state.membership_cb
                if cb is not None:
                    try:
                        cb(m)
                    except Exception:
                        get_logger().exception(
                            "membership-change callback failed")

    t = threading.Thread(target=_poll, daemon=True,
                         name="bps-membership-poll")
    _state.membership_poll_thread = t
    t.start()


def on_membership_change(callback, poll_s: Optional[float] = None) -> None:
    """Register ``callback(membership)`` to fire when the membership epoch
    changes (join, leave, eviction); size() and rank() already follow the
    new epoch when it runs.  A poller re-fetches the view every ``poll_s``
    seconds (default ``BYTEPS_TPU_MEMBERSHIP_POLL_S``) while a callback is
    registered or elasticity is armed.  ``None`` unregisters.  PS mode
    only."""
    _require_init()
    cfg = _state.config or get_config()
    if callback is None:
        _state.membership_cb = None
        if cfg.evict_timeout_s <= 0 and _state.membership_poll_stop \
                is not None:
            _state.membership_poll_stop.set()
            _state.membership_poll_stop = None
            _state.membership_poll_thread = None
        return
    if _state.ps_session is None:
        raise RuntimeError(
            "bps.on_membership_change() requires PS mode "
            "(BYTEPS_TPU_PS_MODE=1); the collective plane resizes "
            "through suspend()/resume()")
    _state.membership_cb = callback
    _start_membership_poller(poll_s if poll_s is not None
                             else cfg.membership_poll_s)


# ---------------------------------------------------------------------------
# PS staging: device tensors to float32 host buffers and back
# ---------------------------------------------------------------------------
def _stage_out(dk: int, t: torch.Tensor) -> torch.Tensor:
    """A float32 host copy of ``t`` in a buffer of key ``dk`` (pinned for
    a CUDA tensor), the copy finished before it returns: the session
    sends views of this memory and may replay them after a reconnect, so
    the buffer belongs to the round until ``_stage_release``."""
    n = t.numel()
    pinned = t.is_cuda
    buf = None
    with _state.lock:
        free = _state.stage_free.get(dk)
        while free:
            cand = free.pop()
            if cand.numel() == n and cand.is_pinned() == pinned:
                buf = cand
                break
    if buf is None:
        buf = torch.empty(n, dtype=torch.float32, pin_memory=pinned)
    t0 = time.perf_counter()
    buf.copy_(t.detach().reshape(-1))
    st = _state.staging
    st["to_host_ms"] += (time.perf_counter() - t0) * 1e3
    st["to_host_bytes"] += n * 4
    st["copies"] += 1
    return buf


def _stage_release(dk: int, buf: torch.Tensor) -> None:
    """Return a staging buffer once its round has completed."""
    with _state.lock:
        _state.stage_free.setdefault(dk, []).append(buf)


def _stage_in(out: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The pulled float32 sum on ``like``'s device, in ``like``'s (the
    pushed wire tensor's) dtype and shape."""
    t0 = time.perf_counter()
    res = torch.from_numpy(np.ascontiguousarray(out, np.float32).ravel()
                           ).to(like.device)
    if like.is_cuda:
        torch.cuda.current_stream(like.device).synchronize()
    st = _state.staging
    st["to_device_ms"] += (time.perf_counter() - t0) * 1e3
    st["to_device_bytes"] += res.numel() * 4
    return res.reshape(like.shape).to(like.dtype)


def get_staging_stats() -> dict:
    """PS mode's host staging since init: milliseconds and bytes copied
    to the host (push) and back to the tensors' devices (pull), and the
    copies made.  All zero outside PS mode."""
    return dict(_state.staging)


# ---------------------------------------------------------------------------
# Eager push_pull
# ---------------------------------------------------------------------------
def _debug_sample(stage: str, name: str, tensor: torch.Tensor) -> None:
    """BYTEPS_DEBUG_SAMPLE_TENSOR: write a sample of the named tensor to
    stderr at the eager path's host stages, push entry and after
    synchronize, for names that contain the setting.  Setting it is the
    opt-in, whatever BYTEPS_LOG_LEVEL says.  The tensor is copied to the
    host only when its name matches."""
    pat = (_state.config or get_config()).debug_sample_tensor
    if not pat or pat not in name:
        return
    arr = tensor.detach().reshape(-1).to("cpu", torch.float32)
    head = ", ".join(f"{v:.6g}" for v in arr[:4].tolist())
    sys.stderr.write(
        f"[byteps_tpu DEBUG_SAMPLE] {stage} name={name} "
        f"shape={tuple(tensor.shape)} dtype={_dtype_name(tensor.dtype)} "
        f"norm2={float(arr.norm()):.6g} sum={float(arr.sum()):.6g} "
        f"first=[{head}]\n")
    sys.stderr.flush()


class _PSWork:
    """One PS round of a staged buffer, the ``work`` of a handle in PS
    mode: ``wait()`` gives the pulled float32 sum and hands the buffer
    back for reuse (a failed round keeps it: late partitions may still
    read it)."""

    def __init__(self, handle, dk: int, buf: torch.Tensor):
        self.handle, self.dk, self.buf = handle, dk, buf

    def is_completed(self) -> bool:
        return self.handle.done()

    def wait(self) -> np.ndarray:
        out = self.handle.wait()
        _stage_release(self.dk, self.buf)
        return out


def push_pull_async(tensor: torch.Tensor, name: Optional[str] = None,
                    average: bool = True, priority: int = 0,
                    compression=None) -> int:
    """Start a sum (or average) of ``tensor`` over the workers; returns a
    handle for ``synchronize``/``poll``.  The caller's tensor is not
    modified.  ``priority`` orders the PS dispatcher's partitions
    (higher first); the process group runs collectives in issue order."""
    _require_init()
    from ..ops.compression import Compression
    compression = compression or Compression.none
    core = _core()
    if name is None:
        name = f"byteps_tpu.tensor_{core.num_declared()}"
    _debug_sample("push", name, tensor)
    dk = declare(name)
    handle = core.handle_allocate()
    t0 = core.trace_now_us()
    wire, ctx = compression.compress(tensor.detach())
    work = None
    cfg = _state.config or get_config()
    if _state.ps_session is not None:
        buf = _stage_out(dk, wire)
        work = _PSWork(_state.ps_session.push_pull_async(
            dk, buf.numpy(), priority=priority), dk, buf)
    elif size() > 1 or (cfg.force_distributed and is_distributed()):
        # BYTEPS_FORCE_DISTRIBUTED takes the real reduce at world 1 too,
        # the JAX package's test hook; without a process group there is
        # nothing to reduce over and the tensor stays as it is.
        wire = wire.clone()
        work = dist.all_reduce(wire, async_op=True)
    if cfg.telemetry_on:
        telemetry.record_pushpull(tensor.numel() * tensor.element_size())
    with _state.lock:
        _state.handles[handle] = (wire, work, compression, ctx, average,
                                  name, t0)
    return handle


def synchronize(handle: int) -> torch.Tensor:
    """Wait for the handle's reduce and return its result (a new tensor).
    ValueError for a handle never allocated or already synchronized."""
    with _state.lock:
        if handle not in _state.handles:
            raise ValueError(
                f"unknown or already-synchronized handle {handle}")
        wire, work, compression, ctx, average, name, t0 = \
            _state.handles.pop(handle)
    if isinstance(work, _PSWork):
        # The float32 sum in the wire's dtype, as the session hands it
        # back in the JAX package, then decompressed and averaged.
        out = compression.decompress(_stage_in(work.wait(), wire), ctx)
    else:
        if work is not None:
            work.wait()
        out = compression.decompress(wire, ctx)
    if average:
        out = out / size()
    _debug_sample("pull", name, out)
    core = _core()
    core.handle_mark_done(handle)
    core.trace_record(name, "PUSH_PULL", t0, core.trace_now_us() - t0)
    core.handle_release(handle)
    return out


def poll(handle: int) -> bool:
    """True once the handle's reduce has completed.  ValueError for a
    handle never allocated or already synchronized."""
    with _state.lock:
        entry = _state.handles.get(handle)
    if entry is None:
        if _core().handle_poll(handle) == -1:
            raise ValueError(
                f"unknown or already-synchronized handle {handle}")
        return True
    work = entry[1]
    return work is None or work.is_completed()


def push_pull(tensor: torch.Tensor, name: Optional[str] = None,
              average: bool = True, priority: int = 0,
              compression=None) -> torch.Tensor:
    """Synchronous eager reduce across workers: a new tensor.  The training
    hot path is ``DistributedOptimizer`` / ``ops.collectives``."""
    return synchronize(push_pull_async(tensor, name=name, average=average,
                                       priority=priority,
                                       compression=compression))


def push_pull_sparse(name: str, indices, rows) -> np.ndarray:
    """Row-sparse push_pull against a declared server-resident embedding
    key (docs/sparse-embedding.md): merge this worker's ``(indices,
    rows)`` gradient into the key's open round and return the published
    rows for the same indices, as float32 host rows.  PS mode only; most
    callers want the sharded ``EmbeddingTable``, which also declares the
    table and arms its optimizer."""
    _require_init()
    if _state.ps_session is None:
        raise RuntimeError(
            "push_pull_sparse needs PS mode (the row-sparse plane is a "
            "PS-tier feature; the collective plane has no lookup tier)")
    return _state.ps_session.push_pull_sparse(declare(name), indices,
                                              rows)


def _dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's dtype string ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def _tree_name(prefix: str, paths, metas) -> str:
    """A tree's batch name from its structure and leaf signature, so that
    every worker maps the same tree to the same keys."""
    sig = hashlib.md5("|".join(
        f"{p}:{tuple(s)}:{_dtype_name(d)}"
        for p, (s, d, _) in zip(paths, metas)).encode()).hexdigest()[:12]
    return f"{prefix}.{sig}"


def push_pull_tree(tree: Tree, name: Optional[str] = None,
                   average: bool = True, compression=None,
                   leaf_names=None, fusion_bytes: Optional[int] = None
                   ) -> Tree:
    """Sum/average every leaf of a tree (nested dicts and lists of
    tensors, flattened as ``common.tree`` does) across workers.

    With fusion on (``BYTEPS_TPU_FUSION_BYTES`` > 0, default 1 MiB, or the
    ``fusion_bytes`` argument), floating leaves below the threshold pack
    into the fusion planner's dtype-homogeneous buckets, one named
    push_pull each at the max priority of its members; larger leaves go
    solo, and the units are dispatched by descending priority.  With it
    off, the floating leaves travel as one float32 vector.  Non-floating
    leaves always travel alone and exact, and so, in PS mode, does a leaf
    whose ``leaf_names`` entry has a wire compressor registered
    (``register_compressor``): its compression is the key's own.
    ``leaf_names`` aligns with the flattened leaf order; unnamed leaves are
    named by the batch name and their path in the tree (``['key'][0]``),
    as in the JAX package.

    In PS mode the fused units ride one ``PSSession.push_pull_group``, so
    the session's scheduler sees them all before the first dispatch, and
    an actuated ``FUSION_BYTES`` (the session's ``live_fusion_bytes()``)
    takes the place of the configured threshold.
    """
    _require_init()
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    paths = tree_paths(tree)
    metas = [(l.shape, l.dtype, l.numel()) for l in leaves]
    cfg = _state.config or get_config()
    sess = _state.ps_session
    if fusion_bytes is not None:
        fb = int(fusion_bytes)
    else:
        fb = sess.live_fusion_bytes() if sess is not None else None
        if fb is None:
            fb = cfg.fusion_bytes
    compressed = set(sess._compressors) if sess is not None else set()

    def separate(i: int) -> bool:
        if not leaves[i].is_floating_point():
            return True
        return bool(compressed) and leaf_names is not None and \
            _core().get_declared_key(str(leaf_names[i])) in compressed

    sep_idx = [i for i in range(len(leaves)) if separate(i)]
    sep = set(sep_idx)
    batch_idx = [i for i in range(len(leaves)) if i not in sep]
    if name is None:
        name = _tree_name("byteps_tpu.tree", paths, metas)

    def leaf_name(i: int) -> str:
        return str(leaf_names[i]) if leaf_names is not None \
            else f"{name}{paths[i]}"

    outs: list = [None] * len(leaves)

    def scatter(members, vec) -> None:
        off = 0
        for li, n in members:
            shp, dt, _ = metas[li]
            outs[li] = vec[off:off + n].reshape(shp).to(dt)
            off += n

    if fb > 0 and len(batch_idx) > 1:
        from .fusion import plan_buckets
        plan = plan_buckets(tuple(
            (i, metas[i][2], _dtype_name(metas[i][1]),
             leaves[i].element_size()) for i in batch_idx), fb)
        plan.record_use()
        units = []     # (name, payload, priority, compression, members)
        for b in plan.buckets:
            packed = torch.cat([leaves[li].detach().reshape(-1)
                                for li, _ in b.members])
            units.append((f"{name}.{b.tag}", packed, b.priority,
                          compression, list(b.members)))
        for li, prio in plan.solo:
            units.append((leaf_name(li), leaves[li].detach().reshape(-1),
                          prio, compression, [(li, metas[li][2])]))
        for i in sep_idx:
            comp = compression if leaves[i].is_floating_point() else None
            units.append((leaf_name(i), leaves[i].detach().reshape(-1), i,
                          comp, [(i, metas[i][2])]))
        units.sort(key=lambda u: -u[2])
        if sess is not None:
            plan_units = ({f"{name}.{b.tag}" for b in plan.buckets}
                          | {leaf_name(li) for li, _ in plan.solo})
            _ps_group(units, plan_units, average, scatter, leaf_name)
            return tree_unflatten(tree, outs)
        handles = [push_pull_async(payload, name=nm, average=average,
                                   priority=prio, compression=comp)
                   for nm, payload, prio, comp, _ in units]
        for (_, _, _, _, members), h in zip(units, handles):
            scatter(members, synchronize(h))
        return tree_unflatten(tree, outs)
    for i in sep_idx:
        outs[i] = push_pull(leaves[i], name=leaf_name(i),
                            average=average).to(metas[i][1])
    if batch_idx:
        flat = torch.cat([leaves[i].detach().reshape(-1).float()
                          for i in batch_idx])
        scatter([(i, metas[i][2]) for i in batch_idx],
                push_pull(flat, name=name, average=average,
                          compression=compression))
    return tree_unflatten(tree, outs)


def _ps_group(units, plan_units, average, scatter, leaf_name) -> None:
    """PS mode: stage every unit (compressed on its device first), hand
    them to the session as one group, then bring each pulled sum back and
    scatter it.  ``plan_units`` names the units whose key comes from the
    fusion plan: the session withdraws them (``KnobReplan``, raised here;
    the re-plan comes with the knob plane's tuner) rather than replaying
    them when an actuated ``FUSION_BYTES`` changes mid-flight."""
    from ..ops.compression import Compression
    sess = _state.ps_session
    items, held, fusion_dks = [], [], []
    unit_bytes = 0
    for nm, payload, prio, comp, members in units:
        _debug_sample("push", nm, payload)
        comp = comp or Compression.none
        wire, ctx = comp.compress(payload)
        dk = declare(nm)
        if nm in plan_units:
            fusion_dks.append(dk)
        if len(members) > 1 and _core().trace_on:
            # Trace spans of a fused bucket name its member leaves.
            sess.set_trace_members(dk, [leaf_name(li) for li, _ in members])
        buf = _stage_out(dk, wire)
        items.append((dk, buf.numpy(), prio))
        held.append((comp, ctx, wire, dk, buf))
        unit_bytes += payload.numel() * payload.element_size()
    if fusion_dks:
        sess.note_fusion_keys(fusion_dks)
    handles = sess.push_pull_group(items)
    for (nm, _, _, _, members), h, (comp, ctx, wire, dk, buf) in zip(
            units, handles, held):
        got = h.wait()
        _stage_release(dk, buf)
        out = comp.decompress(_stage_in(got, wire), ctx)
        if average:
            out = out / size()
        scatter(members, out.reshape(-1))
        _debug_sample("pull", nm, out)
    if (_state.config or get_config()).telemetry_on:
        telemetry.record_pushpull(unit_bytes)


# ---------------------------------------------------------------------------
# Broadcast
# ---------------------------------------------------------------------------
def broadcast_parameters(params: Tree, root_rank: int = 0) -> Tree:
    """``params`` with root_rank's values on every worker: a new tree of
    the same structure.  Tensor leaves travel as they are; number leaves
    as float64 tensors, given back as their type.

    In PS mode, as in the reference BytePS, every worker but the root
    zeroes its leaves and the tree is summed through the servers, so the
    values travel as float32, the PS wire's type: exact for float32 and
    16-bit floats and for integers below 2^24."""
    _require_init()
    if size() == 1:
        return params
    if _state.ps_session is not None:
        leaves = tree_leaves(params)
        keep = rank() == root_rank
        sent = []
        for leaf in leaves:
            t = leaf.detach() if torch.is_tensor(leaf) \
                else torch.tensor(float(leaf), dtype=torch.float64)
            sent.append(t if keep else torch.zeros_like(t))
        name = _tree_name("byteps_tpu.broadcast", tree_paths(params),
                          [(t.shape, t.dtype, t.numel()) for t in sent])
        got = tree_leaves(push_pull_tree(
            tree_unflatten(params, sent), name=name, average=False))
        return tree_unflatten(params, [
            g if torch.is_tensor(l) else type(l)(g.item())
            for l, g in zip(leaves, got)])
    leaves = tree_leaves(params)
    # NCCL moves CUDA tensors only: other leaves cross on the current card.
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    bufs, works = [], []
    for leaf in leaves:
        if torch.is_tensor(leaf):
            buf = leaf.detach().clone()
            if buf.device.type != dev.type:
                buf = buf.to(dev)
        else:
            buf = torch.tensor(float(leaf), dtype=torch.float64, device=dev)
        bufs.append(buf)
        works.append(dist.broadcast(buf, src=root_rank, async_op=True))
    for w in works:
        w.wait()
    out = [b.to(l.device) if torch.is_tensor(l) else type(l)(b.item())
           for l, b in zip(leaves, bufs)]
    return tree_unflatten(params, out)


def broadcast_optimizer_state(opt_state: Tree, root_rank: int = 0) -> Tree:
    """Optimizer-state counterpart of ``broadcast_parameters``."""
    return broadcast_parameters(opt_state, root_rank)


# ---------------------------------------------------------------------------
# Speed, step counter and trace window
# ---------------------------------------------------------------------------
def get_pushpull_speed() -> tuple:
    """(timestamp, MB/s): the bytes every push_pull of the last 10 seconds
    handed in, over 10 seconds (the JAX package's window).  Served from
    the telemetry registry's window, which every push_pull feeds with
    ``telemetry.record_pushpull`` beside ``bps_pushpull_bytes_total``, so
    the getter and the endpoint cannot disagree."""
    return (time.time(), telemetry.pushpull_speed_mbps())


def mark_step() -> None:
    """Advance the training-step counter that drives the trace window
    (``BYTEPS_TRACE_ON``, ``BYTEPS_TRACE_START_STEP``/``END_STEP``): each
    step inside it records a STEP span beside the PUSH_PULL spans, and the
    step after the window writes ``<BYTEPS_TRACE_DIR>/<local_rank>/
    comm.json``."""
    cfg = _state.config or get_config()
    core = _core()
    now = core.trace_now_us()
    if cfg.trace_on and _state.step_start_us is not None \
            and cfg.trace_start_step <= _state.step <= cfg.trace_end_step:
        core.trace_record(f"step_{_state.step}", "STEP",
                          _state.step_start_us, now - _state.step_start_us)
    if cfg.telemetry_on and _state.step_start_us is not None:
        # Per-step wall time: the trace keeps it only inside its window;
        # the registry keeps the full-run distribution live.
        telemetry.get_registry().histogram(
            "bps_step_time_seconds",
            bounds=telemetry.STEP_TIME_BUCKETS,
            help="wall time between consecutive mark_step() calls"
        ).observe((now - _state.step_start_us) / 1e6)
    _state.step += 1
    _state.step_start_us = now
    if cfg.trace_on:
        core.trace_enable(cfg.trace_start_step <= _state.step
                          <= cfg.trace_end_step)
        if _state.step == cfg.trace_end_step + 1:
            _maybe_dump_trace()


def current_step() -> int:
    return _state.step


def _maybe_dump_trace(exiting: bool = False) -> None:
    cfg = _state.config or get_config()
    core = _core()
    if not cfg.trace_on or core.trace_count() == 0:
        return
    d = os.path.join(cfg.trace_dir, str(local_rank()))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "comm.json")
    core.trace_dump(path, rank())
    _merge_trace(path, exiting=exiting)


def _dump_trace_on_exit() -> None:
    """atexit guard: flush whatever the tracer still holds (a run that
    crashed or failed its watchdog never reaches the window-end dump)."""
    try:
        _maybe_dump_trace(exiting=True)
    except Exception:
        pass


def _server_trace_events(core, events: list, meta: list,
                         exiting: bool = False) -> None:
    """PS mode: each server's spans, offset onto this worker's clock, on
    pid = SERVER_PID_BASE + server (named by process_name metadata);
    fused buckets' spans gain ``args.members``.  A server that cannot be
    reached leaves the worker's half alone.  On the exit path the fetch
    gets a shorter budget: fail fast, keep the worker's half."""
    sess = _state.ps_session
    try:
        if exiting:
            spans = sess.fetch_server_trace(timeout=2.0, ping_timeout=1.0,
                                            ping_samples=2)
        else:
            spans = sess.fetch_server_trace(timeout=5.0, ping_timeout=2.0,
                                            ping_samples=3)
    except Exception as e:
        get_logger().warning("server trace unavailable: %s", e)
        spans = []
    seen = set()
    for s in spans:
        dk, pidx = s["key"] >> 16, s["key"] & 0xFFFF
        nm = core.declared_name(dk) or f"key_{dk}"
        seen.add(s["server"])
        events.append({
            "name": f"{nm}.part{pidx}", "cat": "comm", "ph": "X",
            "ts": s["ts_us"], "dur": s["dur_us"],
            "pid": trace_analysis.SERVER_PID_BASE + s["server"],
            "tid": s["stage"],
            "args": {"key": s["key"], "round": s["round"],
                     "worker": s["worker"], "bytes": s["bytes"]}})
    for i in sorted(seen):
        meta.append({"name": "process_name", "ph": "M",
                     "pid": trace_analysis.SERVER_PID_BASE + i,
                     "tid": 0, "args": {"name": f"server{i}"}})
    members = sess.trace_members()
    if members:
        for e in events:
            k = (e.get("args") or {}).get("key")
            if k is not None and (k >> 16) in members:
                e["args"]["members"] = members[k >> 16]


def _merge_trace(path: str, exiting: bool = False) -> None:
    """Fold the device lane and, in PS mode, the servers' lanes into the
    freshly dumped worker trace.

    The result is one Chrome/Perfetto JSON with a process lane per
    source: this worker's spans on pid = rank, each server's on
    SERVER_PID_BASE + its index, the device plane's step spans on pid =
    DEVICE_PID_BASE + rank (on the same monotonic-µs timebase, so with
    no offset).  The file then goes through the critical-path analyzer,
    which feeds the ``bps_step_critical_path_*`` gauges."""
    try:
        with open(path) as f:
            doc = json.load(f)
        events = doc.get("traceEvents", [])
        meta = [{"name": "process_name", "ph": "M", "pid": rank(),
                 "tid": 0, "args": {"name": f"worker{rank()}"}}]
        if _state.ps_session is not None:
            _server_trace_events(_core(), events, meta, exiting)
        prof = devprof.active()
        if prof is not None:
            dev_events = prof.trace_events(rank())
            if dev_events:
                events.extend(dev_events)
                meta.append({
                    "name": "process_name", "ph": "M",
                    "pid": trace_analysis.DEVICE_PID_BASE + rank(),
                    "tid": 0,
                    "args": {"name": f"device{rank()} "
                             f"({prof.probe()['platform']})"}})
        doc["traceEvents"] = meta + events
        with open(path, "w") as f:
            json.dump(doc, f)
    except (OSError, ValueError):
        get_logger().exception("merged trace export failed")
        return
    result = trace_analysis.analyze(doc["traceEvents"], worker=rank())
    trace_analysis.update_critical_path_gauges(result)


# ---------------------------------------------------------------------------
# Observability getters, collectors and the signal plane
# ---------------------------------------------------------------------------
def _register_builtin_collectors() -> None:
    """Attach the stats accessors to the registry as collectors:
    ``bps_codec_*``, ``bps_transport_*`` and ``bps_fusion_*`` values equal
    ``get_codec_stats()``, ``get_transport_stats()`` and
    ``get_fusion_stats()`` by construction.  Idempotent (re-registering
    replaces the same name)."""
    from .fusion import get_stats as get_fusion_stats
    reg = telemetry.get_registry()
    reg.register_collector("codec", lambda: get_codec_stats())
    reg.register_collector("transport", lambda: get_transport_stats())
    reg.register_collector("fusion", get_fusion_stats)


_register_builtin_collectors()


def get_metrics() -> dict:
    """One isolated snapshot of the unified metrics registry: every
    registered counter/gauge/histogram (push_pull bytes, step time, the
    device plane's gauges, doctor findings, the PS feeds) plus the
    collector-backed ``bps_codec_*``, ``bps_transport_*`` and
    ``bps_fusion_*`` values.  Purely local: ``get_server_stats()`` polls
    the servers."""
    return telemetry.get_registry().snapshot()


def _refresh_server_metrics() -> None:
    """Exporter refresh hook: fold a fresh CMD_STATS poll into the
    registry, so that every scrape carries the servers' state.  Quiet
    outside PS mode and while the servers cannot be reached."""
    if _state.ps_session is None:
        return
    try:
        get_server_stats()
    except Exception as e:
        get_logger().debug("CMD_STATS poll failed: %s", e)


def get_server_stats() -> dict:
    """Live server-side stats (CMD_STATS), merged across servers: per-key
    merge counts, completed rounds, pending pulls and pushed bytes,
    per-worker push counts and round position, server wire bytes.  Folds
    the per-worker round lag into ``bps_worker_round_lag`` (a straggler
    warning past ``BYTEPS_TPU_STRAGGLER_ROUNDS``) and the membership,
    ring, server-optimizer, embedding, replication and fleet sections
    into their gauges.  The all-zero shape outside PS mode."""
    if _state.ps_session is None:
        return {"bytes_in": 0, "bytes_out": 0, "async": False,
                "num_workers": 0, "keys": {}, "workers": {},
                "round_lag": {}}
    cfg = _state.config or get_config()
    stats = _state.ps_session.server_stats()
    stats["round_lag"] = telemetry.update_round_lag(
        stats, cfg.straggler_rounds)
    if "members" in stats:
        telemetry.update_membership(
            {"epoch": stats.get("epoch", 0), "workers": stats["members"]})
    if stats.get("servers"):
        telemetry.update_ring(stats)
    telemetry.update_server_opt(stats)
    telemetry.update_embed(stats)
    telemetry.update_repl(stats)
    telemetry.update_fleet(stats)
    return stats


def get_health() -> dict:
    """The gradient-health monitor's last per-key samples
    (``BYTEPS_TPU_HEALTH_SAMPLE_ROUNDS`` > 0, PS mode): norm, absmax,
    non-finite counts and EF residual per key, the ``bps_grad_*`` gauges'
    values.  The empty shape outside PS mode or with the monitor off."""
    empty = {"sample_rounds": 0, "nonfinite_total": 0, "keys": {}}
    if _state.ps_session is None:
        return empty
    return _state.ps_session.health_snapshot() or empty


def get_audit(cross_check: bool = False) -> dict:
    """The consistency auditor (``BYTEPS_TPU_AUDIT=1``, PS mode): the
    local counters (audited pulls, digest mismatches, lost or skewed
    rounds, the last verdict), or with ``cross_check=True`` this worker's
    last pulled digests against every server's CMD_AUDIT window."""
    if _state.ps_session is None:
        return {"armed": False, "checked": 0, "mismatches": 0,
                "round_skew": 0, "unverified": 0, "last": None}
    if cross_check:
        return _state.ps_session.audit_check()
    return _state.ps_session.audit_stats()


def get_codec_stats() -> Dict[str, int]:
    """The PS codec pipeline's counters (``BYTEPS_TPU_COMPRESS_THREADS``):
    parts encoded and decoded off the caller's and receiver's threads,
    bytes raw and on the wire, and the pool's busy time.  All zero
    outside PS mode."""
    if _state.ps_session is not None:
        return _state.ps_session.codec_stats()
    from ..server.codec_pool import CompressionPool
    return dict(CompressionPool.ZERO_STATS)


def get_transport_stats() -> Dict[str, int]:
    """The PS transport's counters: reconnects, replays, parked
    partitions, watchdog trips, ring redirects, the receive pool, and the
    lanes' bytes (``lanes``: one row per server and lane).  All zero
    outside PS mode."""
    if _state.ps_session is not None:
        return _state.ps_session.transport_stats()
    from ..server.client import PSSession
    return {**PSSession.TRANSPORT_ZERO_STATS, "lanes": []}


def _postmortem_extra() -> dict:
    """Bundle sections the flight recorder collects at dump time —
    strictly local state (the step counter, the cached membership)."""
    out: dict = {"step": _state.step}
    if _state.membership is not None:
        out["membership"] = _state.membership
    return out


def _start_signal_plane(cfg: Config) -> None:
    """Arm the windowed key-signal plane + doctor engine
    (``BYTEPS_TPU_SIGNAL_WINDOW_S`` > 0).  In data-parallel mode its only
    provider is the device plane's ``window_roll`` (when armed): it
    re-probes the sentinel, drains the step accumulators and updates the
    MFU / fallback gauges, and the section it returns rides the summary
    for the ``device_fallback`` / ``mfu_regression`` rules.  The doctor's
    findings ride the log, the flight recorder,
    ``bps_doctor_findings_total`` and ``bps.get_diagnosis()``; bundles
    gain a ``diagnosis`` section and the window history."""
    eng = doctor_mod.DoctorEngine()
    sess = _state.ps_session
    providers = {}
    refresh = None
    if sess is not None:
        providers = {"transport": sess.transport_stats,
                     "health": sess.health_snapshot,
                     "audit": sess.audit_stats}

        def refresh():
            if _state.ps_session is None:
                return None
            try:
                return get_server_stats()
            except Exception as e:
                get_logger().debug(
                    "signal window CMD_STATS poll failed: %s", e)
                return None
    prof = devprof.active()
    if prof is not None:
        providers["device"] = prof.window_roll
    plane = signals.arm(window_s=cfg.signal_window_s,
                        history=cfg.signal_history, refresh=refresh,
                        providers=providers, on_window=eng.observe)
    _state.signal_plane = plane
    _state.doctor = eng
    _state.doctor_verdict_done = False
    flightrec.set_extra_provider(
        lambda: {"diagnosis": eng.diagnosis(),
                 "signals": plane.history()},
        name="doctor")
    if not _state.doctor_atexit:
        # Crash guard: a run that never reaches shutdown() still logs
        # its one-line verdict.
        import atexit
        atexit.register(_emit_doctor_verdict)
        _state.doctor_atexit = True


def _emit_doctor_verdict() -> None:
    """Log the final doctor verdict exactly once per plane lifetime."""
    eng = _state.doctor
    if eng is None or _state.doctor_verdict_done:
        return
    _state.doctor_verdict_done = True
    if eng.diagnosis().get("healthy"):
        get_logger().info(eng.verdict_line())
    else:
        get_logger().warning(eng.verdict_line())


def _stop_signal_plane() -> None:
    if _state.signal_plane is None:
        return
    _state.signal_plane.stop(final_roll=True)   # close the last window
    _emit_doctor_verdict()
    # Freeze the final diagnosis + window history into a static provider:
    # the atexit bundle (flightrec's own exit hook runs AFTER shutdown)
    # must still carry the run's verdict.
    final = {"diagnosis": _state.doctor.diagnosis(),
             "signals": _state.signal_plane.history()}
    flightrec.set_extra_provider(lambda: final, name="doctor")
    signals.disarm()
    _state.signal_plane = None
    _state.doctor = None


def _signal_routes() -> dict:
    """JSON routes for the metrics endpoint: ``/signals`` (the window
    history — what tools/bps_doctor.py polls in live mode),
    ``/diagnosis`` (the doctor's verdict — what bps_top's panel shows)
    and ``/device`` (the device plane's profile, when armed).  Empty when
    the plane is off: the endpoint then 404s the paths, which the
    consumers treat as "not armed"."""
    if _state.signal_plane is None:
        return {}
    plane, eng = _state.signal_plane, _state.doctor

    def _signals_payload():
        hist = plane.history()
        return {"schema": signals.SCHEMA,
                "window_s": plane.window_s,
                "window": (hist[-1].get("window") if hist else -1),
                "windows": hist}

    routes = {"/signals": _signals_payload,
              "/diagnosis": lambda: eng.diagnosis()}
    if devprof.active() is not None:
        routes["/device"] = get_device_profile
    return routes


def get_key_signals() -> dict:
    """The signal plane's last closed window: per-key ``KeySignal``
    records and their ``wire_bound | compute_bound | straggler_bound |
    tiny | unhealthy`` classification (no keys in data-parallel mode: the
    PS client feeds them).  The empty shape when the plane is off
    (``BYTEPS_TPU_SIGNAL_WINDOW_S=0``)."""
    if _state.signal_plane is None:
        return {"schema": signals.SCHEMA, "armed": False, "window": -1,
                "keys": {}}
    out = _state.signal_plane.key_signals()
    out["armed"] = True
    return out


def get_diagnosis() -> dict:
    """The doctor's current verdict: open findings (severity-ranked,
    each with rule id, subject, evidence, and a playbook anchor into
    docs/troubleshooting.md), plus the recent finding history.
    ``{"armed": False, "healthy": True, ...}`` when the plane is off."""
    if _state.doctor is None:
        return {"armed": False, "healthy": True, "open": [],
                "findings_total": 0}
    return _state.doctor.diagnosis()


def get_device_profile() -> dict:
    """The device plane's live profile (``BYTEPS_TPU_DEVPROF=1``): the
    last sentinel probe (actual vs intended platform, fallback
    conviction), lifetime and recent per-step device times (dispatch →
    stream synchronize), the last window's MFU, and the FLOP-count cache
    (``cost_cache``: ``misses`` steps ran under the counter and are not
    timed, ``hits`` timed steps read its count, ``flops`` the counts).
    Served on the metrics endpoint as ``/device``.  ``{"armed": False,
    ...}`` when the plane is off."""
    prof = devprof.active()
    if prof is None:
        return {"armed": False, "platform": None, "mfu": None,
                "steps_total": 0, "device_s_total": 0.0,
                "mean_step_ms": None}
    return prof.profile()


# ---------------------------------------------------------------------------
# Not ported yet
# ---------------------------------------------------------------------------
get_hierarchy = _not_ported("get_hierarchy", "6c")
get_tuner = _not_ported("get_tuner", "7b")
get_autoscaler = _not_ported("get_autoscaler", "7b")
get_fleet = _not_ported("get_fleet", "7b")
