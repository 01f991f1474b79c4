"""Environment-variable configuration surface (the part this package reads).

Counterpart of ``byteps_tpu/common/config.py``: the same variable names and
defaults, limited to what the port uses so far — the worker bootstrap
(``DMLC_*``, ``BYTEPS_LOCAL_*``), the global-rank override and the
forced-distributed switch, the bucket size, the eager fusion threshold,
the async switch, the streaming fusion buffer's deadline, the PS
server's engine threads and schedule switch, the consistent-hash ring,
the PS mode and every knob its client (``server/client.py``) and the
API's PS branches read (role, servers, compression threshold, lanes,
UDS, socket buffers, codec threads, credit, reconnect, watchdog,
barrier, leases and membership, server failover, auditor, health
monitor, key hash, clock sync, straggler warning, fleet, hierarchy and
slice size), the trace window, the log level, the debug sampling
of eager tensors, the mesh axis sizes (``parallel/mesh.py``) and the
observability planes' knobs (telemetry, metrics endpoint and log, flight
recorder, signal window, device plane).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)


_TRUTHY = ("1", "true", "yes", "on")


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() in _TRUTHY


def _env_str(name: str, default: str) -> str:
    v = os.environ.get(name)
    return default if v is None or v == "" else v


@dataclasses.dataclass
class Config:
    """Snapshot of the knobs, built by ``Config.from_env()``."""

    role: str = "worker"                     # DMLC_ROLE
    worker_id: int = 0                       # DMLC_WORKER_ID
    num_worker: int = 1                      # DMLC_NUM_WORKER
    num_server: int = 0                      # DMLC_NUM_SERVER
    scheduler_uri: str = "127.0.0.1"         # DMLC_PS_ROOT_URI
    scheduler_port: int = 9000               # DMLC_PS_ROOT_PORT
    local_rank: int = 0                      # BYTEPS_LOCAL_RANK
    local_size: int = 1                      # BYTEPS_LOCAL_SIZE
    global_rank: Optional[int] = None        # BYTEPS_GLOBAL_RANK override
    force_distributed: bool = False          # BYTEPS_FORCE_DISTRIBUTED
    partition_bytes: int = 4 * 1024 * 1024   # BYTEPS_PARTITION_BYTES
    fusion_bytes: int = 1024 * 1024          # BYTEPS_TPU_FUSION_BYTES
    # Streaming fusion buffer: an open bucket flushes this long after it
    # opened, full or not (0 = only when full or drained).
    fusion_flush_ms: float = 5.0             # BYTEPS_TPU_FUSION_FLUSH_MS
    enable_async: bool = False               # BYTEPS_ENABLE_ASYNC
    # PS mode: the eager path and DistributedOptimizer reduce through the
    # PS servers (server/client.py) instead of torch.distributed.
    ps_mode: bool = False                    # BYTEPS_TPU_PS_MODE
    min_compress_bytes: int = 65536          # BYTEPS_MIN_COMPRESS_BYTES
    wire_conns: int = 4                      # BYTEPS_TPU_WIRE_CONNS
    server_uds: str = ""                     # BYTEPS_TPU_SERVER_UDS
    sock_buf_kb: int = 0                     # BYTEPS_TPU_SOCK_BUF_KB
    compress_threads: int = 2                # BYTEPS_TPU_COMPRESS_THREADS
    scheduling_credit: int = 0               # BYTEPS_SCHEDULING_CREDIT
    reconnect_attempts: int = 0              # BYTEPS_TPU_RECONNECT_ATTEMPTS
    reconnect_backoff_ms: float = 100.0      # BYTEPS_TPU_RECONNECT_BACKOFF_MS
    stall_timeout_s: float = 0.0             # BYTEPS_TPU_STALL_TIMEOUT_S
    barrier_timeout_s: float = 0.0           # BYTEPS_TPU_BARRIER_TIMEOUT_S
    evict_timeout_s: float = 0.0             # BYTEPS_TPU_EVICT_TIMEOUT_S
    membership_poll_s: float = 2.0           # BYTEPS_TPU_MEMBERSHIP_POLL_S
    server_evict_timeout_s: float = 0.0      # BYTEPS_TPU_SERVER_EVICT_TIMEOUT_S
    audit: bool = False                      # BYTEPS_TPU_AUDIT
    audit_window: int = 16                   # BYTEPS_TPU_AUDIT_WINDOW
    health_sample_rounds: int = 0            # BYTEPS_TPU_HEALTH_SAMPLE_ROUNDS
    key_hash_fn: str = "djb2"                # BYTEPS_KEY_HASH_FN
    clock_sync_s: float = 30.0               # BYTEPS_TPU_CLOCK_SYNC_S
    straggler_rounds: int = 10               # BYTEPS_TPU_STRAGGLER_ROUNDS
    fleet: bool = False                      # BYTEPS_TPU_FLEET
    fleet_windows: int = 32                  # BYTEPS_TPU_FLEET_WINDOWS
    # Hierarchical reduction over the PS tier (ROADMAP.md Queue 1 item
    # 6c; raises in PS mode until then) and its slice size, which the
    # client's leader election reads.
    hierarchy: bool = False                  # BYTEPS_TPU_HIERARCHY
    slice_size: int = 1                      # BYTEPS_TPU_SLICE_SIZE
    # PS server (server/__init__.py serve).
    server_engine_threads: int = 4           # BYTEPS_SERVER_ENGINE_THREAD
    server_enable_schedule: bool = False     # BYTEPS_SERVER_ENABLE_SCHEDULE
    # Consistent-hash ring over the PS servers (common/ring.py); unarmed,
    # keys are placed by the fixed hash.
    ring: bool = False                       # BYTEPS_TPU_RING
    ring_vnodes: int = 64                    # BYTEPS_TPU_RING_VNODES
    trace_on: bool = False                   # BYTEPS_TRACE_ON
    trace_start_step: int = 10               # BYTEPS_TRACE_START_STEP
    trace_end_step: int = 20                 # BYTEPS_TRACE_END_STEP
    trace_dir: str = "./traces"              # BYTEPS_TRACE_DIR
    log_level: str = "WARNING"               # BYTEPS_LOG_LEVEL
    # Log a sample of every eager push_pull tensor whose name contains
    # this substring, at push entry and after synchronize ("" = off).
    debug_sample_tensor: str = ""            # BYTEPS_DEBUG_SAMPLE_TENSOR
    # Mesh axis sizes; mesh_dp 0 means "the rest of the world".
    mesh_dp: int = 0                         # BYTEPS_TPU_MESH_DP
    mesh_tp: int = 1                         # BYTEPS_TPU_MESH_TP
    mesh_sp: int = 1                         # BYTEPS_TPU_MESH_SP
    mesh_pp: int = 1                         # BYTEPS_TPU_MESH_PP
    mesh_ep: int = 1                         # BYTEPS_TPU_MESH_EP
    # Hierarchical reduce: ranks per intra-node island (0 = one island).
    ici_size: int = 0                        # BYTEPS_TPU_ICI_SIZE
    # Observability planes (common/telemetry.py, flightrec.py, signals.py,
    # doctor.py, devprof.py).
    telemetry_on: bool = True                # BYTEPS_TELEMETRY_ON
    metrics_port: int = 0                    # BYTEPS_TPU_METRICS_PORT
    metrics_log: str = ""                    # BYTEPS_TPU_METRICS_LOG
    metrics_log_mb: int = 64                 # BYTEPS_TPU_METRICS_LOG_MB
    flightrec_events: int = 4096             # BYTEPS_TPU_FLIGHTREC_EVENTS
    postmortem_dir: str = ""                 # BYTEPS_TPU_POSTMORTEM_DIR
    signal_window_s: float = 10.0            # BYTEPS_TPU_SIGNAL_WINDOW_S
    signal_history: int = 32                 # BYTEPS_TPU_SIGNAL_HISTORY
    devprof: bool = False                    # BYTEPS_TPU_DEVPROF
    device_platform: str = ""                # BYTEPS_TPU_DEVICE_PLATFORM

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            role=_env_str("DMLC_ROLE", "worker"),
            worker_id=_env_int("DMLC_WORKER_ID", 0),
            num_worker=_env_int("DMLC_NUM_WORKER", 1),
            num_server=_env_int("DMLC_NUM_SERVER", 0),
            scheduler_uri=_env_str("DMLC_PS_ROOT_URI", "127.0.0.1"),
            scheduler_port=_env_int("DMLC_PS_ROOT_PORT", 9000),
            local_rank=_env_int("BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BYTEPS_LOCAL_SIZE", 1),
            global_rank=_env_int("BYTEPS_GLOBAL_RANK", None),
            force_distributed=_env_bool("BYTEPS_FORCE_DISTRIBUTED"),
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES",
                                     4 * 1024 * 1024),
            fusion_bytes=_env_int("BYTEPS_TPU_FUSION_BYTES", 1024 * 1024),
            fusion_flush_ms=float(
                os.environ.get("BYTEPS_TPU_FUSION_FLUSH_MS") or 5.0),
            enable_async=_env_bool("BYTEPS_ENABLE_ASYNC"),
            ps_mode=_env_bool("BYTEPS_TPU_PS_MODE"),
            min_compress_bytes=_env_int("BYTEPS_MIN_COMPRESS_BYTES", 65536),
            wire_conns=_env_int("BYTEPS_TPU_WIRE_CONNS", 4),
            server_uds=_env_str("BYTEPS_TPU_SERVER_UDS", ""),
            sock_buf_kb=_env_int("BYTEPS_TPU_SOCK_BUF_KB", 0),
            compress_threads=_env_int("BYTEPS_TPU_COMPRESS_THREADS", 2),
            scheduling_credit=_env_int("BYTEPS_SCHEDULING_CREDIT", 0),
            reconnect_attempts=_env_int("BYTEPS_TPU_RECONNECT_ATTEMPTS", 0),
            reconnect_backoff_ms=float(
                os.environ.get("BYTEPS_TPU_RECONNECT_BACKOFF_MS") or 100.0),
            stall_timeout_s=float(
                os.environ.get("BYTEPS_TPU_STALL_TIMEOUT_S") or 0.0),
            barrier_timeout_s=float(
                os.environ.get("BYTEPS_TPU_BARRIER_TIMEOUT_S") or 0.0),
            evict_timeout_s=float(
                os.environ.get("BYTEPS_TPU_EVICT_TIMEOUT_S") or 0.0),
            membership_poll_s=float(
                os.environ.get("BYTEPS_TPU_MEMBERSHIP_POLL_S") or 2.0),
            server_evict_timeout_s=float(
                os.environ.get("BYTEPS_TPU_SERVER_EVICT_TIMEOUT_S") or 0.0),
            audit=_env_bool("BYTEPS_TPU_AUDIT"),
            audit_window=_env_int("BYTEPS_TPU_AUDIT_WINDOW", 16),
            health_sample_rounds=_env_int(
                "BYTEPS_TPU_HEALTH_SAMPLE_ROUNDS", 0),
            key_hash_fn=_env_str("BYTEPS_KEY_HASH_FN", "djb2"),
            clock_sync_s=float(
                os.environ.get("BYTEPS_TPU_CLOCK_SYNC_S") or 30.0),
            straggler_rounds=_env_int("BYTEPS_TPU_STRAGGLER_ROUNDS", 10),
            fleet=_env_bool("BYTEPS_TPU_FLEET"),
            fleet_windows=_env_int("BYTEPS_TPU_FLEET_WINDOWS", 32),
            hierarchy=_env_bool("BYTEPS_TPU_HIERARCHY"),
            slice_size=max(1, _env_int("BYTEPS_TPU_SLICE_SIZE", 1)),
            server_engine_threads=_env_int("BYTEPS_SERVER_ENGINE_THREAD", 4),
            server_enable_schedule=_env_bool("BYTEPS_SERVER_ENABLE_SCHEDULE"),
            ring=_env_bool("BYTEPS_TPU_RING"),
            ring_vnodes=_env_int("BYTEPS_TPU_RING_VNODES", 64),
            trace_on=_env_bool("BYTEPS_TRACE_ON"),
            trace_start_step=_env_int("BYTEPS_TRACE_START_STEP", 10),
            trace_end_step=_env_int("BYTEPS_TRACE_END_STEP", 20),
            trace_dir=_env_str("BYTEPS_TRACE_DIR", "./traces"),
            log_level=_env_str("BYTEPS_LOG_LEVEL", "WARNING"),
            debug_sample_tensor=_env_str("BYTEPS_DEBUG_SAMPLE_TENSOR", ""),
            mesh_dp=_env_int("BYTEPS_TPU_MESH_DP", 0),
            mesh_tp=_env_int("BYTEPS_TPU_MESH_TP", 1),
            mesh_sp=_env_int("BYTEPS_TPU_MESH_SP", 1),
            mesh_pp=_env_int("BYTEPS_TPU_MESH_PP", 1),
            mesh_ep=_env_int("BYTEPS_TPU_MESH_EP", 1),
            ici_size=_env_int("BYTEPS_TPU_ICI_SIZE", 0),
            telemetry_on=_env_bool("BYTEPS_TELEMETRY_ON", True),
            metrics_port=_env_int("BYTEPS_TPU_METRICS_PORT", 0),
            metrics_log=_env_str("BYTEPS_TPU_METRICS_LOG", ""),
            metrics_log_mb=_env_int("BYTEPS_TPU_METRICS_LOG_MB", 64),
            flightrec_events=_env_int("BYTEPS_TPU_FLIGHTREC_EVENTS", 4096),
            postmortem_dir=_env_str("BYTEPS_TPU_POSTMORTEM_DIR", ""),
            signal_window_s=float(
                os.environ.get("BYTEPS_TPU_SIGNAL_WINDOW_S") or 10.0),
            signal_history=_env_int("BYTEPS_TPU_SIGNAL_HISTORY", 32),
            devprof=_env_bool("BYTEPS_TPU_DEVPROF"),
            device_platform=_env_str("BYTEPS_TPU_DEVICE_PLATFORM", ""),
        )


_config: Optional[Config] = None


def get_config(refresh: bool = False) -> Config:
    """Process-wide config singleton; ``refresh=True`` re-reads the env."""
    global _config
    if _config is None or refresh:
        _config = Config.from_env()
    return _config
