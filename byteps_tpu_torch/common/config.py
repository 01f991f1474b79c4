"""Environment-variable configuration surface (the part this package reads).

Counterpart of ``byteps_tpu/common/config.py``: the same variable names and
defaults, limited to what the port uses so far — the worker bootstrap
(``DMLC_*``, ``BYTEPS_LOCAL_*``), the bucket size and the log level.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)


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
    partition_bytes: int = 4 * 1024 * 1024   # BYTEPS_PARTITION_BYTES
    log_level: str = "WARNING"               # BYTEPS_LOG_LEVEL

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            worker_id=_env_int("DMLC_WORKER_ID", 0),
            num_worker=_env_int("DMLC_NUM_WORKER", 1),
            scheduler_uri=_env_str("DMLC_PS_ROOT_URI", "127.0.0.1"),
            scheduler_port=_env_int("DMLC_PS_ROOT_PORT", 9000),
            local_rank=_env_int("BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BYTEPS_LOCAL_SIZE", 1),
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES",
                                     4 * 1024 * 1024),
            log_level=_env_str("BYTEPS_LOG_LEVEL", "WARNING"),
        )


_config: Optional[Config] = None


def get_config(refresh: bool = False) -> Config:
    """Process-wide config singleton; ``refresh=True`` re-reads the env."""
    global _config
    if _config is None or refresh:
        _config = Config.from_env()
    return _config
