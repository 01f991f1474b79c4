"""Leveled logger gated by BYTEPS_LOG_LEVEL (TRACE..FATAL), as in
``byteps_tpu/common/logging.py``, under the logger name byteps_tpu_torch."""

from __future__ import annotations

import logging
import os
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "TRACE": TRACE,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
}

_FMT = "[%(asctime)s] [%(levelname)s] byteps_tpu_torch: %(message)s"

_logger: logging.Logger | None = None


def _resolve(name: str) -> int:
    """Level name (TRACE..FATAL) -> numeric level; unknown -> WARNING."""
    return _LEVELS.get(str(name).upper(), logging.WARNING)


def set_level(name: str) -> None:
    get_logger().setLevel(_resolve(name))


def set_rank(rank: int | None) -> None:
    """Stamp the worker rank into the log prefix (None: no rank)."""
    fmt = _FMT if rank is None else _FMT.replace(
        "byteps_tpu_torch:", f"byteps_tpu_torch[{int(rank)}]:")
    for h in get_logger().handlers:
        h.setFormatter(logging.Formatter(fmt, datefmt="%H:%M:%S"))


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        lg = logging.getLogger("byteps_tpu_torch")
        lg.setLevel(_resolve(os.environ.get("BYTEPS_LOG_LEVEL", "WARNING")))
        if not lg.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
            lg.addHandler(h)
        lg.propagate = False
        _logger = lg
    return _logger


def trace(msg: str, *args) -> None:
    get_logger().log(TRACE, msg, *args)
