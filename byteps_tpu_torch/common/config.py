"""Environment-variable configuration surface (the part this package reads).

Counterpart of ``byteps_tpu/common/config.py``: the same variable names and
defaults, limited to what the port uses so far — the worker bootstrap
(``DMLC_*``, ``BYTEPS_LOCAL_*``), the global-rank override and the
forced-distributed switch, the bucket size, the eager fusion threshold,
the async switch, the trace window, the log level, the debug sampling
of eager tensors and the mesh axis sizes (``parallel/mesh.py``).
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

    worker_id: int = 0                       # DMLC_WORKER_ID
    num_worker: int = 1                      # DMLC_NUM_WORKER
    scheduler_uri: str = "127.0.0.1"         # DMLC_PS_ROOT_URI
    scheduler_port: int = 9000               # DMLC_PS_ROOT_PORT
    local_rank: int = 0                      # BYTEPS_LOCAL_RANK
    local_size: int = 1                      # BYTEPS_LOCAL_SIZE
    global_rank: Optional[int] = None        # BYTEPS_GLOBAL_RANK override
    force_distributed: bool = False          # BYTEPS_FORCE_DISTRIBUTED
    partition_bytes: int = 4 * 1024 * 1024   # BYTEPS_PARTITION_BYTES
    fusion_bytes: int = 1024 * 1024          # BYTEPS_TPU_FUSION_BYTES
    enable_async: bool = False               # BYTEPS_ENABLE_ASYNC
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

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            worker_id=_env_int("DMLC_WORKER_ID", 0),
            num_worker=_env_int("DMLC_NUM_WORKER", 1),
            scheduler_uri=_env_str("DMLC_PS_ROOT_URI", "127.0.0.1"),
            scheduler_port=_env_int("DMLC_PS_ROOT_PORT", 9000),
            local_rank=_env_int("BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BYTEPS_LOCAL_SIZE", 1),
            global_rank=_env_int("BYTEPS_GLOBAL_RANK", None),
            force_distributed=_env_bool("BYTEPS_FORCE_DISTRIBUTED"),
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES",
                                     4 * 1024 * 1024),
            fusion_bytes=_env_int("BYTEPS_TPU_FUSION_BYTES", 1024 * 1024),
            enable_async=_env_bool("BYTEPS_ENABLE_ASYNC"),
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
        )


_config: Optional[Config] = None


def get_config(refresh: bool = False) -> Config:
    """Process-wide config singleton; ``refresh=True`` re-reads the env."""
    global _config
    if _config is None or refresh:
        _config = Config.from_env()
    return _config
